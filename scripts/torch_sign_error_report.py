"""Per-shape sign-error report for reconstruction grid queries, with the
PyTorch port (``points2surf_tpu_torch``; counterpart of
``scripts/sign_error_report.py``).

Usage:
  python scripts/torch_sign_error_report.py DATASET_DIR TESTSET RESULTS_DIR...

e.g.
  python scripts/torch_sign_error_report.py datasets/proc_120 testset.txt \\
      results/r3gate_f32_model/proc_120 results/r3thin_model/proc_120

For every shape in TESTSET, computes the ground-truth signed distance at
the model's saved reconstruction query points (rec/query_pts_ms/*.xyz.npy,
identical across models for the same cloud and grid) against the GT mesh
in DATASET_DIR/03_meshes (``ops.meshdist.signed_distance``, on the card
unless ``--device cpu``), then reports each model's sign-error rate from
its rec/dist_ms predictions: the sign quality at the queries that feed
sign propagation. GT distances are cached in ``--cache_dir`` (default
``<temp dir>/p2s_gt_signs/<dataset>``, one ``<shape>.npy`` each, the JAX
script's layout).
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from points2surf_tpu_torch.ops import meshdist  # noqa: E402
from points2surf_tpu_torch.utils import mesh_io  # noqa: E402


def _gt_signed_distance(args, cache, shape, q):
    """The GT signed distances of ``q``, from the cache when it holds them
    for as many queries."""
    cf = os.path.join(cache, shape + ".npy")
    if os.path.isfile(cf):
        gt = np.load(cf)
        if len(gt) == len(q):
            return gt
    v, f = mesh_io.load_mesh(
        os.path.join(args.dataset_dir, "03_meshes", shape + ".ply"))
    gt = meshdist.signed_distance(v.astype(np.float32), f, q,
                                  device=args.device)
    np.save(cf, gt)
    return gt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset_dir")
    ap.add_argument("testset")
    ap.add_argument("results_dirs", nargs="+",
                    help="results/<model>/<dataset> dirs containing rec/")
    ap.add_argument("--cache_dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="device of the GT distances (cuda or cpu)")
    args = ap.parse_args(argv)

    cache = args.cache_dir or os.path.join(
        tempfile.gettempdir(), "p2s_gt_signs",
        os.path.basename(args.dataset_dir.rstrip("/")))
    os.makedirs(cache, exist_ok=True)

    with open(os.path.join(args.dataset_dir, args.testset)) as fh:
        shapes = [line.strip() for line in fh if line.strip()]

    names = [d.rstrip("/").split("/")[-2] for d in args.results_dirs]
    print(f"{'shape':16s}" + "".join(f"{n[:18]:>20s}" for n in names))
    tot = {d: [0, 0] for d in args.results_dirs}
    for s in shapes:
        qf = os.path.join(args.results_dirs[0], "rec/query_pts_ms",
                          s + ".xyz.npy")
        if not os.path.isfile(qf):
            print(f"{s:16s}  (no reconstruction queries, skipped)")
            continue
        q = np.load(qf).astype(np.float32)
        gti = _gt_signed_distance(args, cache, s, q) > 0
        row = f"{s:16s}"
        for d in args.results_dirs:
            pred = np.load(os.path.join(d, "rec/dist_ms", s + ".xyz.npy")) > 0
            err = pred != gti
            tot[d][0] += int(err.sum())
            tot[d][1] += err.size
            row += f"{err.mean() * 100:19.2f}%"
        print(row, flush=True)
    print(f"{'TOTAL':16s}" + "".join(
        f"{100 * tot[d][0] / max(tot[d][1], 1):19.2f}%"
        for d in args.results_dirs))


if __name__ == "__main__":
    main()
