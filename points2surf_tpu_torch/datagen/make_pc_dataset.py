"""Reconstruction-only datasets from user point clouds (counterpart of
``points2surf_tpu/datagen/make_pc_dataset.py``; reference
make_pc_dataset.py): normalize to the unit cube, sub-sample to a
maximum point count, write 04_pts/*.xyz.npy + testset.txt.
"""

from __future__ import annotations

import os

import numpy as np

from points2surf_tpu_torch.utils import file_utils, mesh_io


def _convert_point_cloud(file_in, file_out, target_num_points):
    lower = file_in.lower()
    if lower.endswith(".npy"):
        pts = np.load(file_in)
    elif lower.endswith((".xyz", ".txt", ".pts")):
        pts = mesh_io.load_xyz(file_in)
    elif lower.endswith(".ply"):
        pts, _ = mesh_io.read_ply(file_in)
    elif lower.endswith(".off"):
        pts, _ = mesh_io.read_off(file_in)
    else:
        print(f"unsupported point-cloud format: {file_in}")
        return
    pts = np.asarray(pts, np.float32)[:, :3]

    # normalize to unit cube (reference make_pc_dataset.py:39-80)
    lo, hi = pts.min(0), pts.max(0)
    extent = float((hi - lo).max())
    if extent <= 0:
        return
    pts = (pts - (lo + hi) / 2.0) / extent

    # sub-sample to target count
    if pts.shape[0] > target_num_points:
        rng = np.random.RandomState(file_utils.filename_to_hash(file_in))
        ids = rng.choice(pts.shape[0], target_num_points, replace=False)
        pts = pts[ids]

    np.save(file_out, pts.astype(np.float32))


def convert_point_clouds(base_dir, dataset_dir, dir_in="00_base_pc",
                         dir_out="04_pts", target_num_points=50000,
                         num_processes=1):
    from points2surf_tpu_torch.utils.mp import start_process_pool

    in_abs = os.path.join(base_dir, dataset_dir, dir_in)
    out_abs = os.path.join(base_dir, dataset_dir, dir_out)
    os.makedirs(out_abs, exist_ok=True)
    calls = []
    for f in sorted(os.listdir(in_abs)):
        fi = os.path.join(in_abs, f)
        if not os.path.isfile(fi):
            continue
        stem = f.rsplit(".", 1)[0]
        fo = os.path.join(out_abs, stem + ".xyz.npy")
        if file_utils.call_necessary(fi, fo):
            calls.append((fi, fo, target_num_points))
    start_process_pool(_convert_point_cloud, calls, num_processes)


def make_pc_dataset(dataset_name, base_dir="datasets",
                    dir_in="00_base_pc", target_num_points=50000,
                    num_processes=1):
    """Full point-cloud-only pipeline: convert + testset.txt
    (reference make_pc_dataset.py:main)."""
    from points2surf_tpu_torch.datagen.make_dataset import (
        make_dataset_splits)

    convert_point_clouds(base_dir, dataset_name, dir_in,
                         target_num_points=target_num_points,
                         num_processes=num_processes)
    make_dataset_splits(base_dir, dataset_name, "04_pts",
                        only_test_set=True)
