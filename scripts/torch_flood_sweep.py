"""Flood-containment parameter sweep over saved reconstruction predictions,
with the PyTorch port (``points2surf_tpu_torch``; counterpart of
``scripts/flood_sweep.py``).

Re-runs the volume pipeline (splat -> [seed filter] -> sign propagation ->
marching cubes) from an eval run's saved per-shape predictions
(``<rec_dir>/dist_ms`` + ``<rec_dir>/query_pts_ms``, written by
infer/evaluator.py) across a grid of (sigma, certainty_threshold,
seed_filter) settings, and reports Hausdorff/Chamfer against the GT meshes
plus a flood-overflow measure per shape and setting, in the JAX script's
CSV columns. No model inference happens: the volumes are built on the card
(``infer.meshing._build_volume``; ``--device cpu`` asks for the CPU), the
isosurface and the metrics on the host.

Usage:
  python scripts/torch_flood_sweep.py --rec_dir results/<model>/<ds>/rec \\
      --gt_dir datasets/<ds>/03_meshes --grid_res 256 \\
      --sigmas 5 --certainties 13 26 --seed_filters 0 2 4 8 \\
      --out flood_sweep.csv
"""

import argparse
import csv
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from points2surf_tpu_torch.device import require_cuda  # noqa: E402
from points2surf_tpu_torch.evalx import metrics  # noqa: E402
from points2surf_tpu_torch.infer.meshing import _build_volume  # noqa: E402
from points2surf_tpu_torch.ops import marching_cubes  # noqa: E402


def overflow_of(verts: np.ndarray, query_pts: np.ndarray, grid_res: int):
    """How far (model units) the mesh extends beyond the queried band
    (same diagnostic as infer/meshing.py); > 0 indicates flooding."""
    margin = 8.0 / grid_res
    lo = query_pts.min(0) - margin
    hi = query_pts.max(0) + margin
    return float(np.maximum(lo - verts.min(0), verts.max(0) - hi).max())


def _row(name, vol, pts, gt_samples, a, sf, sigma, cert):
    """One CSV row of a built volume (-1 columns: nothing to mesh)."""
    if not (vol.min() < 0.0 < vol.max()):
        return (name, sf, sigma, cert, -1.0, -1.0, -1.0)
    v, fcs = marching_cubes.extract_isosurface(vol, 0.0)
    if v.size == 0:
        return (name, sf, sigma, cert, -1.0, -1.0, -1.0)
    v = (((v + 0.5) / float(a.grid_res)) - 0.5) * 2.0
    rec = metrics.sample_mesh_surface(v.astype(np.float32), fcs, a.samples)
    hd = metrics.hausdorff_distance(rec, gt_samples)[2]
    cd = metrics.chamfer_distance(rec, gt_samples)
    ov = overflow_of(v, pts, a.grid_res)
    return (name, sf, sigma, cert, round(hd, 4), round(cd, 1), round(ov, 4))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--grid_res", type=int, default=256)
    ap.add_argument("--sigmas", type=int, nargs="+", default=[5])
    ap.add_argument("--certainties", type=int, nargs="+", default=[13])
    ap.add_argument("--seed_filters", type=int, nargs="+", default=[0])
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--shapes", nargs="+", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "flood_sweep.csv"))
    ap.add_argument("--device", default="cuda",
                    help="device of the volume builds (cuda or cpu)")
    a = ap.parse_args(argv)
    device = require_cuda(a.device)

    dist_dir = os.path.join(a.rec_dir, "dist_ms")
    pts_dir = os.path.join(a.rec_dir, "query_pts_ms")
    files = sorted(f for f in os.listdir(dist_dir) if f.endswith(".xyz.npy"))
    if a.shapes:
        files = [f for f in files if f[:-8] in a.shapes]

    rows = []
    for f in files:
        name = f[:-8]
        gt_file = os.path.join(a.gt_dir, name + ".ply")
        if not os.path.exists(gt_file):
            print(f"skip {name}: no GT mesh")
            continue
        gt_samples = metrics._sample_mesh_file(gt_file, a.samples)
        dist = np.load(os.path.join(dist_dir, f))
        pts = np.load(os.path.join(pts_dir, f))
        pts_dev = torch.as_tensor(np.asarray(pts, np.float32), device=device)
        dist_dev = torch.as_tensor(np.asarray(dist, np.float32),
                                   device=device)
        for sf in a.seed_filters:
            for sigma in a.sigmas:
                for cert in a.certainties:
                    t0 = time.time()
                    vol = _build_volume(pts_dev, dist_dev, len(pts),
                                        a.grid_res, sigma, cert,
                                        sf).cpu().numpy()
                    rows.append(_row(name, vol, pts, gt_samples, a, sf,
                                     sigma, cert))
                    _, _, _, _, hd, cd, ov = rows[-1]
                    print(f"{name} filt={sf} sigma={sigma} cert={cert}: "
                          f"HD {hd:.4f} CD {cd:.1f} overflow {ov:.4f} "
                          f"({time.time() - t0:.1f}s)")

    with open(a.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["shape", "seed_filter", "sigma", "certainty",
                    "hausdorff", "chamfer", "overflow"])
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {a.out}")

    # summary: per setting, mean/max HD and flood count (overflow > 0)
    agg = defaultdict(list)
    for name, sf, sigma, cert, hd, cd, ov in rows:
        agg[(sf, sigma, cert)].append((hd, ov))
    print("\nsetting: mean_HD max_HD floods/n")
    for key in sorted(agg):
        vals = agg[key]
        hds = [h for h, _ in vals if h >= 0]
        floods = sum(1 for h, o in vals if o > 0 or h < 0)
        mean_hd = sum(hds) / max(len(hds), 1)
        max_hd = max(hds) if hds else -1
        print(f"filt={key[0]} sigma={key[1]} cert={key[2]}: "
              f"{mean_hd:.4f} {max_hd:.4f} {floods}/{len(vals)}")


if __name__ == "__main__":
    main()
