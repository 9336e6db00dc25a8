"""Baseline-comparison tooling (counterpart of
``points2surf_tpu/evalx/baselines.py``; reference eval_dataset.py +
source/figure/compare_dir_of_meshes.py):

* Screened Poisson (SPSR) baseline via external meshlabserver — passthrough
  interface preserved (filter scripts + process pool), since SPSR itself is
  an external tool in the reference too.
* Point-cloud normal estimation from GT meshes (for SPSR input), by the
  exact closest face on the device.
* Chamfer comparison across directories of reconstructed meshes from
  different methods, including AtlasNet de-normalization.
"""

from __future__ import annotations

import os

import numpy as np

from points2surf_tpu_torch.evalx.metrics import chamfer_distance_files
from points2surf_tpu_torch.utils import file_utils, mesh_io
from points2surf_tpu_torch.utils.mesh import Mesh
from points2surf_tpu_torch.utils.mp import mp_worker, start_process_pool

# Minimal meshlab filter scripts (roles of the reference's poisson.mlx /
# normals_poisson.mlx; XML re-authored, not copied).
POISSON_MLX = """<!DOCTYPE FilterScript>
<FilterScript>
 <filter name="Surface Reconstruction: Screened Poisson">
  <Param type="RichInt" value="8" name="depth"/>
  <Param type="RichInt" value="5" name="fullDepth"/>
  <Param type="RichFloat" value="1.1" name="scale"/>
  <Param type="RichFloat" value="4" name="samplesPerNode"/>
  <Param type="RichBool" value="false" name="confidence"/>
  <Param type="RichBool" value="true" name="preClean"/>
 </filter>
</FilterScript>
"""

NORMALS_POISSON_MLX = """<!DOCTYPE FilterScript>
<FilterScript>
 <filter name="Compute normals for point sets">
  <Param type="RichInt" value="10" name="K"/>
  <Param type="RichInt" value="0" name="smoothIter"/>
  <Param type="RichBool" value="false" name="flipFlag"/>
  <Param type="RichPoint3f" x="0" y="0" z="0" name="viewPos"/>
 </filter>
 <filter name="Surface Reconstruction: Screened Poisson">
  <Param type="RichInt" value="8" name="depth"/>
 </filter>
</FilterScript>
"""


def write_filter_scripts(out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "poisson.mlx"), "w") as f:
        f.write(POISSON_MLX)
    with open(os.path.join(out_dir, "normals_poisson.mlx"), "w") as f:
        f.write(NORMALS_POISSON_MLX)


def apply_meshlab_filter(
    base_dir, dataset_dir, dir_in, dir_out, num_processes,
    filter_file, meshlabserver_bin,
):
    """Run a meshlab filter script over a directory of point clouds
    (reference eval_dataset.py:50-67)."""
    dir_in_abs = os.path.join(base_dir, dataset_dir, dir_in)
    dir_out_abs = os.path.join(base_dir, dataset_dir, dir_out)
    os.makedirs(dir_out_abs, exist_ok=True)
    calls = []
    for f in sorted(os.listdir(dir_in_abs)):
        fi = os.path.join(dir_in_abs, f)
        if not os.path.isfile(fi):
            continue
        fo = os.path.join(dir_out_abs, f.rsplit(".", 1)[0] + ".ply")
        if file_utils.call_necessary(fi, fo):
            calls.append(
                (f"{meshlabserver_bin} -i {fi} -o {fo} -s {filter_file}",)
            )
    return start_process_pool(mp_worker, calls, num_processes)


def get_pts_normals(
    base_dir, dataset_dir, dir_in_pointcloud, dir_in_meshes,
    dir_out_normals, samples_per_model=None, num_processes=1, device="cuda",
):
    """GT normals for point clouds from the EXACT closest face of the source
    mesh (reference source/base/utils.py:109-164 +
    point_cloud.get_closest_distance_batched :197-220), via the on-device
    closest-point primitive on ``device``. ``samples_per_model`` is accepted
    for API compatibility and ignored (the exact primitive needs no
    sampling)."""
    from points2surf_tpu_torch.ops.meshdist import closest_point_on_mesh

    d_pts = os.path.join(base_dir, dataset_dir, dir_in_pointcloud)
    d_mesh = os.path.join(base_dir, dataset_dir, dir_in_meshes)
    d_out = os.path.join(base_dir, dataset_dir, dir_out_normals)
    d_out_xyz = os.path.join(d_out, "pts")
    os.makedirs(d_out, exist_ok=True)
    os.makedirs(d_out_xyz, exist_ok=True)

    pts_files = [f for f in sorted(os.listdir(d_pts)) if f.endswith(".npy")]
    for f in pts_files:
        pts_file = os.path.join(d_pts, f)
        mesh_file = os.path.join(d_mesh, f[:-8] + ".ply")
        out_npy = os.path.join(d_out, f)
        out_xyz = os.path.join(d_out_xyz, f[:-8] + ".xyz")
        if not file_utils.call_necessary([pts_file, mesh_file],
                                         [out_npy, out_xyz]):
            continue
        pts = np.load(pts_file)[:, :3].astype(np.float32)
        v, faces = mesh_io.load_mesh(mesh_file)
        _, _, face_ids = closest_point_on_mesh(v, faces, pts, device=device)
        normals = Mesh(v, faces).face_normals[face_ids]
        np.save(out_npy, normals.astype(np.float32))
        mesh_io.write_xyz(out_xyz, pts, normals=normals)


def revert_atlasnet_transform(vertices: np.ndarray,
                              pts_file: str) -> np.ndarray:
    """Undo AtlasNet's per-cloud normalization so its meshes are comparable
    (reference figure/compare_dir_of_meshes.py:12-45): AtlasNet centers on
    the bounding-box midpoint and scales by the max norm."""
    pts = np.load(pts_file)[:, :3]
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2.0
    scale = float(np.linalg.norm(pts - center, axis=1).max())
    return vertices * scale + center


def compare_dirs_of_meshes(
    method_dirs: dict, ref_meshes_dir: str, report_file: str,
    samples_per_model=10000, num_processes=1,
):
    """Chamfer comparison of multiple methods' reconstructions against GT
    (reference figure/compare_dir_of_meshes.py:48-104). method_dirs maps
    method name -> directory of meshes."""
    ref_files = {
        f.split(".")[0]: os.path.join(ref_meshes_dir, f)
        for f in os.listdir(ref_meshes_dir)
        if os.path.isfile(os.path.join(ref_meshes_dir, f))
    }
    rows = {}
    for method, d in method_dirs.items():
        calls = []
        stems = []
        for f in sorted(os.listdir(d)):
            stem = f.split(".")[0]
            if stem in ref_files:
                calls.append(
                    (os.path.join(d, f), ref_files[stem], samples_per_model)
                )
                stems.append(stem)
        results = start_process_pool(
            chamfer_distance_files, calls, num_processes
        )
        for stem, r in zip(stems, results):
            rows.setdefault(stem, {})[method] = r[2]

    methods = list(method_dirs.keys())
    lines = ["shape," + ",".join(methods)]
    for stem in sorted(rows):
        cells = [str(rows[stem].get(m, "")) for m in methods]
        lines.append(stem + "," + ",".join(cells))
    file_utils.make_dir_for_file(report_file)
    with open(report_file, "w") as f:
        f.write("\n".join(lines))
    return rows
