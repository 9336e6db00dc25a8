"""DeepSDF-format dataset exporter (counterpart of
``points2surf_tpu/datagen/deepsdf.py``; reference dataset_for_deepsdf.py).

Converts a Points2Surf dataset into DeepSDF's layouts:

* training: ``SdfSamples/<dataset>/<class>/<shape>.npz`` with ``pos``/
  ``neg`` arrays of (x, y, z, sdf) rows — NOTE DeepSDF's sign convention
  is negative-inside, the opposite of ours/trimesh's, so distances are
  negated on export (reference dataset_for_deepsdf.py convert_sdfs);
* evaluation: ``SurfaceSamples/<dataset>/<class>/<shape>.ply`` point
  clouds wrapped as degenerate-face meshes (reference _convert_pc,
  dataset_for_deepsdf.py:15-72);
* reconstruction: SDF samples synthesized from a scanned point cloud —
  ±eta offsets along per-point normals plus far unit-cube samples signed
  against a hole-filled mesh on the device (reference
  _make_sdf_samples_from_pc, dataset_for_deepsdf.py:103-165);

plus the hole-filling/simplification meshlab filter (reference
hole_filling_mesh_simp.mlx, re-authored), a specs.json template and
train/test split json files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from points2surf_tpu_torch.utils import file_utils, mesh_io

SPECS_TEMPLATE = {
    "Description": "exported by points2surf_tpu",
    "DataSource": "data/",
    "TrainSplit": "",
    "TestSplit": "",
    "NetworkArch": "deep_sdf_decoder",
    "NetworkSpecs": {
        "dims": [512, 512, 512, 512, 512, 512, 512, 512],
        "dropout": [0, 1, 2, 3, 4, 5, 6, 7],
        "dropout_prob": 0.2,
        "norm_layers": [0, 1, 2, 3, 4, 5, 6, 7],
        "latent_in": [4],
        "xyz_in_all": False,
        "use_tanh": False,
        "latent_dropout": False,
        "weight_norm": True,
    },
    "CodeLength": 256,
    "NumEpochs": 2001,
    "SnapshotFrequency": 100,
    "ScenesPerBatch": 64,
    "SamplesPerScene": 16384,
    "DataLoaderThreads": 16,
    "ClampingDistance": 0.1,
}


def make_sdf_samples(query_pts: np.ndarray, query_dist: np.ndarray):
    """Split (points, signed dists) into DeepSDF pos/neg arrays.

    DeepSDF: positive = outside. Our convention: positive = inside, so the
    sign is flipped here (reference convert_sdfs flips via its own chain).
    """
    sdf = -query_dist.astype(np.float32)
    rows = np.concatenate(
        [query_pts.astype(np.float32), sdf[:, None]], axis=1
    )
    return rows[sdf >= 0.0], rows[sdf < 0.0]


def convert_sdfs(base_dir, dataset_dir, out_dir, dataset_name=None,
                 class_name="all", file_set=None, train_set=None,
                 test_set=None):
    """Export 05_query_{pts,dist} into SdfSamples npz files + split jsons +
    specs.json.

    ``file_set`` restricts which shapes get GT SdfSamples written (the
    reference exports GT samples for the TRAIN set only; the test set's
    npz files are synthesized from scans by :func:`make_sdf_samples_dir`
    into the same directory — reference dataset_for_deepsdf.py:383-398).
    None = all shapes (standalone use).

    ``train_set``/``test_set`` pin the split JSON contents; callers that
    resolve the sets themselves (export_for_deepsdf) pass them so the
    splits can never disagree with which npz files actually hold GT vs
    scan-synthesized samples. When None, the sets are re-read from the
    dataset's set files with the SAME fallbacks export_for_deepsdf uses
    (no testset.txt -> empty test split, train = everything minus test)."""
    dataset_name = dataset_name or dataset_dir
    d_pts = os.path.join(base_dir, dataset_dir, "05_query_pts")
    d_dist = os.path.join(base_dir, dataset_dir, "05_query_dist")
    d_out = os.path.join(out_dir, "SdfSamples", dataset_name, class_name)
    os.makedirs(d_out, exist_ok=True)

    shapes = []
    for f in sorted(os.listdir(d_pts)):
        if not f.endswith(".npy"):
            continue
        stem = f[:-8]
        shapes.append(stem)
        if file_set is not None and stem not in file_set:
            continue
        pts = np.load(os.path.join(d_pts, f))
        dist = np.load(os.path.join(d_dist, f))
        pos, neg = make_sdf_samples(pts, dist)
        np.savez(os.path.join(d_out, stem + ".npz"), pos=pos, neg=neg)

    def write_split(path, names):
        file_utils.make_dir_for_file(path)
        with open(path, "w") as fh:
            json.dump({dataset_name: {class_name: names}}, fh, indent=2)

    def read_set(name):
        p = os.path.join(base_dir, dataset_dir, name)
        if os.path.isfile(p):
            with open(p) as fh:
                return [ln.strip() for ln in fh if ln.strip()]
        return []

    if test_set is None:
        test_set = read_set("testset.txt")
    if train_set is None:
        train_set = read_set("trainset.txt") or shapes
        train_set = [s for s in train_set if s not in set(test_set)]
    train = [s for s in train_set if s in shapes]
    test = [s for s in test_set if s in shapes]
    write_split(os.path.join(out_dir, "splits", dataset_name + "_train.json"),
                train)
    write_split(os.path.join(out_dir, "splits", dataset_name + "_test.json"),
                test)

    specs = dict(SPECS_TEMPLATE)
    specs["TrainSplit"] = f"splits/{dataset_name}_train.json"
    specs["TestSplit"] = f"splits/{dataset_name}_test.json"
    with open(os.path.join(out_dir, "specs.json"), "w") as fh:
        json.dump(specs, fh, indent=2)
    return shapes


# ------------------------------------------------ mesh / surface samples --

# Hole-filling + simplification meshlab filter for the repaired meshes that
# sign the far reconstruction samples (role of the reference's
# hole_filling_mesh_simp.mlx; XML re-authored, not copied).
HOLE_FILLING_MESH_SIMP_MLX = """<!DOCTYPE FilterScript>
<FilterScript>
 <filter name="Close Holes">
  <Param type="RichInt" value="100" name="MaxHoleSize"/>
  <Param type="RichBool" value="false" name="Selected"/>
  <Param type="RichBool" value="true" name="NewFaceSelected"/>
  <Param type="RichBool" value="true" name="SelfIntersection"/>
 </filter>
 <filter name="Simplification: Quadric Edge Collapse Decimation">
  <Param type="RichInt" value="30000" name="TargetFaceNum"/>
  <Param type="RichFloat" value="0" name="TargetPerc"/>
  <Param type="RichFloat" value="0.3" name="QualityThr"/>
  <Param type="RichBool" value="true" name="PreserveTopology"/>
  <Param type="RichBool" value="true" name="PreserveNormal"/>
  <Param type="RichBool" value="true" name="AutoClean"/>
 </filter>
</FilterScript>
"""


def write_hole_filling_filter(out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "hole_filling_mesh_simp.mlx")
    with open(path, "w") as fh:
        fh.write(HOLE_FILLING_MESH_SIMP_MLX)
    return path


def _read_set(base_dir, dataset_dir, name):
    p = os.path.join(base_dir, dataset_dir, name)
    if not os.path.isfile(p):
        print(f"WARNING: dataset is missing a set file: {p}")
        return None
    with open(p) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


def convert_pcs(in_dir_pts, out_dir_abs, file_set_stems):
    """Export scanned point clouds as DeepSDF SurfaceSamples: PLY 'meshes'
    whose faces are degenerate so separated vertices survive DeepSDF's
    loader (reference _convert_pc, dataset_for_deepsdf.py:15-40)."""
    os.makedirs(out_dir_abs, exist_ok=True)
    written = []
    for f in sorted(os.listdir(in_dir_pts)):
        if not f.endswith(".npy") or f[:-8] not in file_set_stems:
            continue
        out_ply = os.path.join(out_dir_abs, f[:-8] + ".ply")
        in_f = os.path.join(in_dir_pts, f)
        if not file_utils.call_necessary(in_f, out_ply):
            written.append(out_ply)
            continue
        pts = np.load(in_f)[:, :3].astype(np.float32)
        faces = np.zeros((pts.shape[0], 3), np.int32)
        faces[:, 1] = 1
        faces[:, 2] = np.arange(pts.shape[0])
        mesh_io.write_ply(out_ply, pts, faces)
        written.append(out_ply)
    return written


def make_sdf_samples_from_pc(
    pts_file: str,
    normals_file: str,
    mesh_file: str,
    out_npz: str,
    eta: float = 0.01,
    far_samples_ratio: float = 0.2,
    seed: int = 0,
    device="cuda",
):
    """Reconstruction-input SDF samples from a scanned cloud (reference
    _make_sdf_samples_from_pc, dataset_for_deepsdf.py:103-165): each scan
    point is offset ±eta along its normal (DeepSDF paper §6.3), plus a
    far_samples_ratio of uniform unit-cube samples signed against the
    (hole-filled) mesh on ``device``. Signs use DeepSDF's negative-inside
    convention.
    """
    from points2surf_tpu_torch.ops.meshdist import signed_distance

    pts = np.load(pts_file).astype(np.float32)
    if normals_file and os.path.isfile(normals_file):
        normals = (
            np.loadtxt(normals_file, dtype=np.float32)
            if not normals_file.endswith(".npy")
            else np.load(normals_file).astype(np.float32)
        )
    elif pts.shape[1] >= 6:  # our scanner stores normals as columns 3:6
        normals = pts[:, 3:6]
    else:
        raise ValueError(f"no normals available for {pts_file}")
    pts = pts[:, :3]
    normals = normals / np.maximum(
        np.linalg.norm(normals, axis=1, keepdims=True), 1e-12
    )

    # near-surface pairs: +eta offset is outside (DeepSDF sdf +eta),
    # -eta offset is inside (sdf -eta)
    outside = np.concatenate(
        [pts + eta * normals, np.full((len(pts), 1), eta, np.float32)],
        axis=1,
    )
    inside = np.concatenate(
        [pts - eta * normals, np.full((len(pts), 1), -eta, np.float32)],
        axis=1,
    )

    rng = np.random.RandomState(seed)
    n_far = int(2 * len(pts) * far_samples_ratio)
    far_pts = (rng.rand(n_far, 3) - 0.5).astype(np.float32)
    verts, faces = mesh_io.load_mesh(mesh_file)
    far_sdf = -signed_distance(verts, faces, far_pts,
                               device=device)  # flip to DeepSDF
    far_rows = np.concatenate([far_pts, far_sdf[:, None]], axis=1)

    file_utils.make_dir_for_file(out_npz)
    np.savez(
        out_npz,
        pos=outside.astype(np.float32),
        neg=inside.astype(np.float32),
        pos_far=far_rows[far_sdf >= 0.0],
        neg_far=far_rows[far_sdf < 0.0],
    )


def make_sdf_samples_dir(
    in_dir_pts, in_dir_normals, in_dir_meshes, out_dir_sdf, file_set_stems,
    eta: float = 0.01, far_samples_ratio: float = 0.2, device="cuda",
):
    """Directory driver for make_sdf_samples_from_pc (reference
    make_sdf_samples, dataset_for_deepsdf.py:199-227)."""
    os.makedirs(out_dir_sdf, exist_ok=True)
    for f in sorted(os.listdir(in_dir_pts)):
        if not f.endswith(".npy") or f[:-8] not in file_set_stems:
            continue
        stem = f[:-8]
        normals_file = ""
        if in_dir_normals and os.path.isdir(in_dir_normals):
            for cand in (stem + ".normals", stem + ".xyz.npy", f):
                p = os.path.join(in_dir_normals, cand)
                if os.path.isfile(p):
                    normals_file = p
                    break
        make_sdf_samples_from_pc(
            os.path.join(in_dir_pts, f),
            normals_file,
            os.path.join(in_dir_meshes, stem + ".ply"),
            os.path.join(out_dir_sdf, stem + ".npz"),
            eta=eta, far_samples_ratio=far_samples_ratio, device=device,
        )


def export_for_deepsdf(
    base_dir, dataset_dir, out_dir, dataset_name=None, class_name="all",
    meshlabserver_bin=None, num_processes=4, device="cuda",
):
    """Full DeepSDF export (reference dataset_for_deepsdf.py main,
    :340-400): hole-fill meshes (when meshlabserver is available, else the
    originals sign the far samples), SdfSamples from GT queries (train),
    SurfaceSamples from scans (eval), synthesized SDF samples from scans
    (reconstruction, signed on ``device``), splits + specs."""
    dataset_name = dataset_name or dataset_dir
    ds = os.path.join(base_dir, dataset_dir)

    mesh_dir = os.path.join(ds, "03_meshes")
    repaired_dir = os.path.join(ds, "05_meshes_repaired")
    if meshlabserver_bin:
        from points2surf_tpu_torch.evalx.baselines import (
            apply_meshlab_filter)

        filter_file = write_hole_filling_filter(ds)
        apply_meshlab_filter(
            base_dir, dataset_dir, "03_meshes", "05_meshes_repaired",
            num_processes, filter_file, meshlabserver_bin,
        )
    sign_mesh_dir = (
        repaired_dir if os.path.isdir(repaired_dir) and
        os.listdir(repaired_dir) else mesh_dir
    )

    # train/test must be DISJOINT over the shared SdfSamples dir: GT query
    # samples for the train set, scan-synthesized samples for the test set
    # (reference dataset_for_deepsdf.py:383-398). With no set files, treat
    # everything as train (GT samples) and export no reconstruction inputs.
    d_pts = os.path.join(ds, "05_query_pts")
    all_stems = [
        f[:-8] for f in sorted(os.listdir(d_pts)) if f.endswith(".npy")
    ]
    test = _read_set(base_dir, dataset_dir, "testset.txt") or []
    train = _read_set(base_dir, dataset_dir, "trainset.txt") or all_stems
    train = [s for s in train if s not in set(test)]
    shapes = convert_sdfs(
        base_dir, dataset_dir, out_dir, dataset_name, class_name,
        file_set=set(train), train_set=train, test_set=test,
    )
    convert_pcs(
        os.path.join(ds, "04_pts"),
        os.path.join(out_dir, "SurfaceSamples", dataset_name, class_name),
        set(test),
    )
    make_sdf_samples_dir(
        os.path.join(ds, "04_pts"),
        os.path.join(ds, "06_normals_pcpnet"),
        sign_mesh_dir,
        os.path.join(out_dir, "SdfSamples", dataset_name, class_name),
        set(test), device=device,
    )
    return shapes
