"""Reconstruction metrics: Chamfer, Hausdorff, SDF MSE, classification
(a copy of ``points2surf_tpu/evalx/metrics.py`` on the port's ``mesh_io``;
the same CSV bytes for the same inputs).

Re-implements the reference's source/base/evaluation.py without trimesh:
meshes are sampled by area-weighted barycentric sampling and compared with
scipy cKDTree nearest-neighbor queries (host-side; these run once per shape,
off the hot path).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import spatial

from points2surf_tpu_torch.utils import file_utils, mesh_io


def sample_mesh_surface(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_samples: int,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Area-weighted uniform surface samples (role of trimesh
    sample_surface_even, reference evaluation.py:230-236)."""
    if rng is None:
        rng = np.random.RandomState(0)
    if len(faces) == 0 or len(vertices) == 0:
        return np.zeros((0, 3), np.float32)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = area.sum()
    if total <= 0:
        return np.zeros((0, 3), np.float32)
    fi = rng.choice(len(faces), size=num_samples, p=area / total)
    u = rng.rand(num_samples, 1)
    v = rng.rand(num_samples, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (v0[fi] + u * (v1[fi] - v0[fi]) + v * (v2[fi] - v0[fi])).astype(
        np.float32
    )


def _sample_mesh_file(mesh_file: str, num_samples: int) -> np.ndarray:
    try:
        verts, faces = mesh_io.load_mesh(mesh_file)
    except Exception:
        return np.zeros((0, 3), np.float32)
    return sample_mesh_surface(verts, faces, num_samples)


def chamfer_distance(samples_a: np.ndarray, samples_b: np.ndarray) -> float:
    """Sum of both-direction NN distances (reference evaluation.py:222-256
    — note: the reference sums rather than means; we preserve that)."""
    tree_a = spatial.cKDTree(samples_a)
    tree_b = spatial.cKDTree(samples_b)
    d_ab, _ = tree_b.query(samples_a, 1)
    d_ba, _ = tree_a.query(samples_b, 1)
    return float(d_ab.sum() + d_ba.sum())


def hausdorff_distance(samples_a: np.ndarray, samples_b: np.ndarray):
    """(directed a->b, directed b->a, symmetric max)
    (reference evaluation.py:282-304)."""
    tree_a = spatial.cKDTree(samples_a)
    tree_b = spatial.cKDTree(samples_b)
    d_ab = float(tree_b.query(samples_a, 1)[0].max())
    d_ba = float(tree_a.query(samples_b, 1)[0].max())
    return d_ab, d_ba, max(d_ab, d_ba)


def chamfer_distance_files(file_in, file_ref, samples_per_model=10000):
    a = _sample_mesh_file(file_in, samples_per_model)
    b = _sample_mesh_file(file_ref, samples_per_model)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return file_in, file_ref, -1.0
    return file_in, file_ref, chamfer_distance(a, b)


def hausdorff_distance_files(file_in, file_ref, samples_per_model=10000):
    a = _sample_mesh_file(file_in, samples_per_model)
    b = _sample_mesh_file(file_ref, samples_per_model)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return file_in, file_ref, -1.0, -1.0, -1.0
    d_ab, d_ba, d = hausdorff_distance(a, b)
    return file_in, file_ref, d_ab, d_ba, d


def eval_predictions(pred_path, gt_path, report_file=None, unsigned=False):
    """Per-shape SDF MSE CSV (reference evaluation.py:84-127)."""
    files = sorted(
        f
        for f in os.listdir(pred_path)
        if os.path.isfile(os.path.join(pred_path, f)) and f.endswith(".npy")
    )
    results = []
    for f in files:
        gt = np.load(os.path.join(gt_path, f[:-8] + ".ply.npy"))
        pred = np.load(os.path.join(pred_path, f))
        if unsigned:
            gt, pred = np.abs(gt), np.abs(pred)
        nz = ((pred != 0.0) | (gt != 0.0))
        l2_sq = (pred - gt) ** 2
        mse = float(l2_sq[nz].mean()) if nz.any() else 0.0
        results.append(
            {
                "file": f,
                "mse": mse,
                "mean_gt": float(gt.mean()),
                "mean_pred": float(pred.mean()),
                "var_gt": float((gt * gt).mean() - gt.mean() ** 2),
                "var_pred": float((pred * pred).mean() - pred.mean() ** 2),
            }
        )
    lines = _format_table(
        results, ["file", "mse", "mean_gt", "mean_pred", "var_gt", "var_pred"]
    )
    if report_file is not None:
        file_utils.make_dir_for_file(report_file)
        with open(report_file, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return results


def _format_table(rows, keys):
    """CSV lines in the reference's format (evaluation.py:129-179)."""
    lines = []
    for d in rows:
        cells = []
        for k in keys:
            v = d[k]
            if isinstance(v, str):
                cells.append(v[:10].replace("_", " ").rjust(max(10, len(k))))
            else:
                cells.append(f"{v:.5f}".rjust(max(10, len(k))))
        lines.append(",".join(cells))
    lines.sort()
    header = ",".join(k.replace("_", " ").rjust(10) for k in keys)
    lines.insert(0, header)
    return lines


def mesh_comparison(
    new_meshes_dir_abs,
    ref_meshes_dir_abs,
    num_processes,
    report_name,
    samples_per_model=10000,
    dataset_file_abs=None,
):
    """Hausdorff + Chamfer CSV over a directory of reconstructed meshes
    (reference evaluation.py:307-393; -1 = no input, -2 = no reference)."""
    from points2surf_tpu_torch.utils.mp import start_process_pool

    if not os.path.isdir(new_meshes_dir_abs):
        print(f"Warning: dir to check doesn't exist: {new_meshes_dir_abs}")
        return

    new_files = [
        f
        for f in os.listdir(new_meshes_dir_abs)
        if os.path.isfile(os.path.join(new_meshes_dir_abs, f))
    ]
    ref_files = [
        f
        for f in os.listdir(ref_meshes_dir_abs)
        if os.path.isfile(os.path.join(ref_meshes_dir_abs, f))
    ]

    if dataset_file_abs is None:
        compare_set = set(f.split(".")[0] for f in ref_files)
    else:
        with open(dataset_file_abs) as f:
            compare_set = set(
                ln.strip().split(".")[0] for ln in f if ln.strip()
            )

    def ref_for(new_f):
        stem = new_f.split(".")[0]
        matches = [f for f in ref_files if f.split(".")[0] == stem]
        return matches[0] if matches else None

    call_params = []
    no_ref = []  # reconstructions without a reference mesh -> -2 rows
    for nf in new_files:
        if nf.split(".")[0] in compare_set:
            rf = ref_for(nf)
            if rf is not None:
                call_params.append(
                    (
                        os.path.join(new_meshes_dir_abs, nf),
                        os.path.join(ref_meshes_dir_abs, rf),
                        samples_per_model,
                    )
                )
            else:
                no_ref.append(nf)
    if not call_params:
        raise ValueError("Results are empty!")

    res_h = start_process_pool(
        hausdorff_distance_files, call_params, num_processes
    )
    res_c = start_process_pool(
        chamfer_distance_files, call_params, num_processes
    )
    results = [
        (h[0], h[1], str(h[2]), str(h[3]), str(h[4]), str(c[2]))
        for h, c in zip(res_h, res_c)
    ]

    # sentinel rows (reference evaluation.py:365-380 + CSV header contract):
    # -2 = reconstruction present but its reference mesh is missing;
    # -1 = compare-set entry with no reconstruction at all.
    for nf in sorted(no_ref):
        results.append(
            (
                os.path.join(new_meshes_dir_abs, nf),
                os.path.join(ref_meshes_dir_abs, nf.split(".")[0]),
                "-2", "-2", "-2", "-2",
            )
        )
    remaining = compare_set - {nf.split(".")[0] for nf in new_files}
    for missing_rec in sorted(remaining):
        results.append(
            (
                os.path.join(new_meshes_dir_abs, missing_rec),
                os.path.join(ref_meshes_dir_abs, missing_rec),
                "-1", "-1", "-1", "-1",
            )
        )

    results = sorted(results, key=lambda x: x[0])
    file_utils.make_dir_for_file(report_name)
    csv_lines = [
        "in mesh,ref mesh,Hausdorff dist new-ref,Hausdorff dist ref-new,"
        "Hausdorff dist,Chamfer dist(-1: no input; -2: no reference)"
    ]
    csv_lines += [",".join(r) for r in results]
    with open(report_name, "w") as f:
        f.write("\n".join(csv_lines))
    return results


def compare_predictions_binary(ground_truth, predicted,
                               prediction_name="comparison") -> dict:
    """Confusion-matrix comparison of two sign arrays
    (reference evaluation.py:39-81); NaN-on-empty semantics preserved."""
    gt = np.asarray(ground_truth) > 0.0
    pr = np.asarray(predicted) > 0.0
    if gt.shape != pr.shape:
        raise ValueError(
            "The ground truth matrix and the predicted matrix have "
            "different sizes!"
        )
    tp = float(np.sum(pr & gt))
    fp = float(np.sum(pr & ~gt))
    fn = float(np.sum(~pr & gt))
    tn = float(np.sum(~pr & ~gt))
    total = tp + fp + fn + tn

    def _div(a, b):
        return a / b if b != 0 else float("nan")

    precision = _div(tp, tp + fp)
    recall = _div(tp, tp + fn)
    return {
        "comp_name": prediction_name,
        "predictions": total,
        "positives": tp + fp,
        "pos_gt": tp + fn,
        "true_pos": tp,
        "true_neg": tn,
        "false_pos": fp,
        "false_neg": fn,
        "true": tp + tn,
        "false": fp + fn,
        "accuracy": _div(tp + tn, total),
        "precision": precision,
        "recall": recall,
        "f1_score": _div(2.0 * precision * recall, precision + recall),
    }


def visualize_patch(patch_pts_ps, query_point_ps, pts_sub_sample_ms,
                    query_point_ms, file_path, patch_pts_ms=None):
    """Debug PLY of one training sample: blue local patch, yellow query
    (patch space), green global sub-sample, magenta query (model space)
    (reference evaluation.py:182-219)."""
    def filter_padding(pts, query):
        same = np.isclose(pts, np.asarray(query)[None, :]).sum(1) == 3
        return pts[~same]

    patch_pts_ps = filter_padding(np.asarray(patch_pts_ps),
                                  np.asarray(query_point_ps))
    groups = [
        (patch_pts_ps, (0.0, 0.0, 1.0)),
        (np.atleast_2d(query_point_ps), (1.0, 1.0, 0.0)),
        (np.asarray(pts_sub_sample_ms), (0.0, 1.0, 0.0)),
        (np.atleast_2d(query_point_ms), (1.0, 0.0, 1.0)),
    ]
    if patch_pts_ms is not None:
        groups.append((filter_padding(np.asarray(patch_pts_ms),
                                      np.asarray(query_point_ms)),
                       (1.0, 0.0, 0.0)))
    pts = np.concatenate([g[0] for g in groups], axis=0)
    colors = np.concatenate(
        [np.tile(c, (len(p), 1)) for p, c in groups], axis=0
    )
    mesh_io.write_ply(file_path, pts, colors=colors)
