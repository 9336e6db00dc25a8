"""The port's ``full_run`` end to end on the CPU at a small size (net 32,
16 patch points, 32 sub-sample points, 48 patches per shape, batch 32, one
epoch, grid 32) on a copy of the bundled dataset: training, the eval pass
and its MSE CSV, the reconstruction, the meshes and the Hausdorff/Chamfer
CSV. Every artefact of the JAX package's layout exists and every CSV row
is finite. ``full_eval`` then evaluates the trained model on the test
split from its command line."""

import os
import shutil

import numpy as np

from points2surf_tpu_torch.cli import eval_args
from points2surf_tpu_torch.cli.full_eval import full_eval
from points2surf_tpu_torch.cli.full_run import STAGES, full_run

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
SHAPE = "00994122_57d9d4755722f9d2d7436f0a_trimesh_000"


def _rows(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_full_run_on_cpu(tmp_path):
    base = tmp_path / "datasets"
    shutil.copytree(ABC, base / "abc_minimal")
    out = tmp_path / "out"
    stages = []
    csv = full_run(base_dir=str(base), out_root=str(out), nepoch=1,
                   batch_size=32, grid_resolution=32, workers=2, net_size=32,
                   points_per_patch=16, sub_sample_size=32,
                   patches_per_shape=48, device="cpu",
                   stage_done=stages.append)
    assert tuple(stages) == STAGES
    res = out / "results" / "vanilla" / "abc_minimal"
    for rel in ("models/vanilla_model.npz", "models/vanilla_model_0.npz",
                "models/vanilla_params.json",
                "models/vanilla_description.txt"):
        assert (out / rel).is_file(), rel
    for rel in (f"eval/eval/{SHAPE}.xyz.npy", f"eval/eval/{SHAPE}.xyz.txt",
                f"eval/vis/{SHAPE}.ply", "eval/rme_comp_res.csv",
                f"rec/dist_ms/{SHAPE}.xyz.npy",
                f"rec/query_pts_ms/{SHAPE}.xyz.npy",
                f"rec/query_pts_ms_vis/{SHAPE}.ply", f"rec/vol/{SHAPE}.off",
                f"rec/mesh/{SHAPE}.ply", "rec/hausdorff_dist_pred_rec.csv"):
        assert (res / rel).is_file(), rel
    assert csv == str(res / "rec" / "hausdorff_dist_pred_rec.csv")
    dist = np.load(res / "rec" / "dist_ms" / f"{SHAPE}.xyz.npy")
    assert dist.shape == np.load(
        res / "rec" / "query_pts_ms" / f"{SHAPE}.xyz.npy").shape[:1]
    assert np.isfinite(dist).all()

    header, rows = _rows(res / "eval" / "rme_comp_res.csv")
    assert header.split(",")[1].strip() == "mse" and len(rows) == 1
    assert np.isfinite([float(v) for v in rows[0][1:]]).all()
    header, rows = _rows(csv)
    assert header.startswith("in mesh,ref mesh") and len(rows) == 1
    assert rows[0][0].endswith(f"{SHAPE}.ply")
    values = np.array([float(v) for v in rows[0][2:]])
    assert np.isfinite(values).all() and (values >= 0).all()

    # full_eval from its command line: eval pass, reconstruction, meshes
    # and both CSVs under <outdir>/<model><postfix stem>/<dataset dir>
    full_eval(eval_args.parse_arguments([
        "--indir", str(base), "--outdir", str(tmp_path / "eval"),
        "--dataset", "abc_minimal/testset.txt", "--modeldir",
        str(out / "models"), "--models", "vanilla",
        "--query_grid_resolution", "32", "--epsilon", "3",
        "--certainty_threshold", "13", "--sigma", "5", "--batchSize", "64",
        "--workers", "1"]), device="cpu")
    ev = tmp_path / "eval" / "vanilla_model" / "abc_minimal"
    for rel in ("eval/rme_comp_res.csv", f"rec/mesh/{SHAPE}.ply",
                "rec/hausdorff_dist_pred_rec.csv"):
        assert (ev / rel).is_file(), rel
    _, rows = _rows(ev / "rec" / "hausdorff_dist_pred_rec.csv")
    assert len(rows) == 1
    assert np.isfinite([float(v) for v in rows[0][2:]]).all()
