"""BlenSor/Blender external-scanner passthrough (counterpart of
``points2surf_tpu/datagen/blensor.py``).

The native on-device scanner (datagen/scanner.py) is the default; this
module preserves the reference's external-tool interface
(make_dataset.py:242-380): per-mesh python scripts rendered from a template
and executed in headless Blender via a process pool. Use when bit-equal
BlenSor sensor simulation is required and a BlenSor binary is available.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from points2surf_tpu_torch.datagen.scanner import (
    _quat_to_rotmat_np,
    scan_poses,
)
from points2surf_tpu_torch.utils import file_utils, mesh_io
from points2surf_tpu_torch.utils.mesh import Mesh
from points2surf_tpu_torch.utils.mp import mp_worker, start_process_pool

# Minimal BlenSor ToF driver script; same placeholders as the reference
# template (blensor_script_template.py) and the same sensor parameters.
SCRIPT_TEMPLATE = '''\
import bpy
from mathutils import Vector, Quaternion
import blensor

evd_files = {evd_files}
obj_locations = {obj_locations}
obj_rotations = {obj_rotations}
scan_sigmas = {scan_sigmas}

bpy.ops.object.select_all(action="DESELECT")
bpy.data.objects["Cube"].select = True
bpy.ops.object.delete()

bpy.ops.import_mesh.ply(filepath='{file_loc}')
obj = bpy.context.selected_objects[0]
obj.rotation_mode = 'QUATERNION'

scanner = bpy.data.objects["Camera"]
scanner.rotation_mode = 'QUATERNION'
scanner.local_coordinates = False
scanner.location = Vector([0.0, 0.0, 0.0])

for i in range(len(evd_files)):
    obj.location = Vector(obj_locations[i])
    obj.rotation_quaternion = Quaternion(obj_rotations[i])
    blensor.tof.scan_advanced(
        scanner, evd_file=evd_files[i], evd_last_scan=True,
        max_distance=10.0, add_blender_mesh=False,
        add_noisy_blender_mesh=False, tof_res_x=176, tof_res_y=144,
        lens_angle_w=43.6, lens_angle_h=34.6, flength=10.0,
        noise_mu=0.0, noise_sigma=scan_sigmas[i], backfolding=False,
    )

bpy.ops.wm.quit_blender()
'''


def write_blensor_scripts(
    base_dir, dataset_dir, dir_in, dir_out_pcd, dir_out_scripts,
    num_scans_per_mesh_min, num_scans_per_mesh_max,
    scanner_noise_sigma_min, scanner_noise_sigma_max,
):
    """Render per-mesh scanning scripts; poses identical to the native
    scanner (same filename-hash RNG). Returns a list of
    ``(script_path, mesh_path, stem, n_scans)`` tuples."""
    dir_in_abs = os.path.join(base_dir, dataset_dir, dir_in)
    dir_pcd_abs = os.path.join(base_dir, dataset_dir, dir_out_pcd)
    dir_scripts_abs = os.path.join(base_dir, dataset_dir, dir_out_scripts)
    os.makedirs(dir_pcd_abs, exist_ok=True)
    os.makedirs(dir_scripts_abs, exist_ok=True)

    scripts = []
    for f in sorted(os.listdir(dir_in_abs)):
        if not f.endswith(".ply"):
            continue
        mesh_file = os.path.join(dir_in_abs, f)
        locations, rotations, sigma = scan_poses(
            mesh_file, num_scans_per_mesh_min, num_scans_per_mesh_max,
            scanner_noise_sigma_min, scanner_noise_sigma_max,
        )
        evd_files = [
            os.path.join(
                dir_pcd_abs, f[:-4] + f"_{str(i).zfill(5)}.numpy.gz"
            )
            for i in range(len(locations))
        ]
        script = SCRIPT_TEMPLATE.format(
            file_loc=mesh_file.replace("\\", "/"),
            evd_files=str(evd_files).replace("\\", "/"),
            obj_locations=str([l.tolist() for l in locations]),
            obj_rotations=str([r.tolist() for r in rotations]),
            scan_sigmas=str([float(sigma)] * len(locations)),
        )
        script_file = os.path.join(dir_scripts_abs, f[:-4] + ".py")
        # don't bump the script's mtime when nothing changed — it is a
        # call_necessary input for the Blender run below
        unchanged = False
        if os.path.isfile(script_file):
            with open(script_file) as fh:
                unchanged = fh.read() == script
        if not unchanged:
            with open(script_file, "w") as fh:
                fh.write(script)
        scripts.append((script_file, mesh_file, f[:-4], len(locations)))
    return scripts


def _expected_scan_files(dir_pcd_abs: str, stem: str, n_scans: int):
    """Scan files BlenSor will write for one mesh: it appends its own
    5-digit frame counter before .numpy.gz (reference make_dataset.py:
    306-308): X.numpy.gz -> X00000.numpy.gz."""
    return [
        os.path.join(dir_pcd_abs, f"{stem}_{str(i).zfill(5)}00000.numpy.gz")
        for i in range(n_scans)
    ]


def run_blensor(blensor_bin, script_files, num_processes=4):
    """Execute the rendered scripts in headless Blender
    (reference make_dataset.py:353-357)."""
    calls = [(f"{blensor_bin} -P {s} -b",) for s in script_files]
    return start_process_pool(mp_worker, calls, num_processes)


# ------------------------------------------------------- scan merge-back --

# BlenSor numpy scan layout (https://www.blensor.org/numpy_import.html,
# reference make_dataset.py:160-173): per ray
#   0 timestamp, 1 yaw, 2 pitch, 3 distance, 4 distance_noise,
#   5:8 x,y,z (noise-free), 8:11 x,y,z (noisy), 11 object_id,
#   12:15 color*255, 15 idx.  distance != 0 marks a hit.
_NF_COLS = slice(5, 8)
_NOISY_COLS = slice(8, 11)


def blensor_vs_to_ws(pts_vs: np.ndarray, obj_location: np.ndarray,
                     obj_rotation_quat: np.ndarray) -> np.ndarray:
    """Undo BlenSor's view-space conventions + the per-scan object pose
    (reference _blensor_vs_to_ws, make_dataset.py:124-144): swap handedness
    (x, -z, y), move back from camera distance, rotate by the inverse of
    the object's pose quaternion (w, x, y, z)."""
    if pts_vs.shape[0] == 0:
        return pts_vs.reshape(0, 3).astype(np.float64)
    ws = np.stack(
        [pts_vs[:, 0], -pts_vs[:, 2], pts_vs[:, 1]], axis=1
    ).astype(np.float64)
    ws -= np.asarray(obj_location, np.float64)
    rot_inv = _quat_to_rotmat_np(np.asarray(obj_rotation_quat)).T
    return ws @ rot_inv.T


def _read_scan(path: str) -> np.ndarray:
    """One BlenSor scan result -> raw (N, >=11) float32 rows."""
    if path.endswith(".numpy.gz"):
        with gzip.GzipFile(path, "r") as fh:
            return np.loadtxt(fh, dtype=np.float32, ndmin=2)
    if path.endswith(".numpy"):
        return np.loadtxt(path, dtype=np.float32, ndmin=2)
    if path.endswith(".pcd"):
        pts, _ = mesh_io.load_pcd(path)
        # ASCII PCD carries only xyz: synthesize raw rows with the points
        # in both the noisy and noise-free slots and distance=1 (hit)
        raw = np.zeros((pts.shape[0], 11), np.float32)
        raw[:, 3] = 1.0
        raw[:, _NF_COLS] = pts
        raw[:, _NOISY_COLS] = pts
        return raw
    raise ValueError(f"Input file {path} has an unknown format!")


def pcd_files_to_pts(
    pcd_files,
    mesh_file: str,
    pts_file_raw_npz: str,
    pts_file_npy: str,
    pts_file_vis: str,
    obj_locations,
    obj_rotations,
    hits_per_scan_file: str,
    min_pts_size: int = 0,
    device="cuda",
) -> bool:
    """Merge BlenSor scan results back into one model-space point cloud
    (reference _pcd_files_to_pts, make_dataset.py:147-239).

    Per scan: keep hit rays, transform noisy + noise-free points to model
    space with the inverse scan pose; after merging, assign each noisy
    point the normal of the mesh face closest to its noise-free twin
    (exact closest-point, ops/meshdist.py, on ``device``). Writes the raw
    scan npz, the (N, 6) xyz+normal npy, a PLY visualization, and
    hits-per-scan npz. Returns True when a cloud was written.
    """
    from points2surf_tpu_torch.ops.meshdist import closest_point_on_mesh

    raw_cat = []
    noisy_cat = []
    noisefree_cat = []
    hits_per_scan = []
    for fi, f in enumerate(pcd_files):
        try:
            raw = _read_scan(f)
        except (EOFError, OSError) as err:
            print(f"Error processing {f}: {err}")
            continue
        raw_cat.append(raw)
        hits = raw[raw[:, 3] != 0.0]
        hits_per_scan.append(hits.shape[0])
        noisy = blensor_vs_to_ws(
            hits[:, _NOISY_COLS], obj_locations[fi], obj_rotations[fi]
        )
        noisefree = blensor_vs_to_ws(
            hits[:, _NF_COLS], obj_locations[fi], obj_rotations[fi]
        )
        if noisy.shape[0] > 0:
            noisy_cat.append(noisy)
            noisefree_cat.append(noisefree)

    if raw_cat:
        np.savez_compressed(
            pts_file_raw_npz, np.concatenate(raw_cat, axis=0)
        )
    if not noisy_cat:
        print(
            f"No scanner hits for object {os.path.basename(mesh_file)} "
            f"in {len(pcd_files)} scans"
        )
        return False

    verts, faces = mesh_io.load_mesh(mesh_file)
    noisefree_merged = np.concatenate(noisefree_cat, axis=0)
    _, _, face_ids = closest_point_on_mesh(
        verts, faces, noisefree_merged.astype(np.float32), device=device
    )
    normals = Mesh(verts, faces).face_normals[face_ids]

    merged = np.concatenate(noisy_cat, axis=0).astype(np.float32)
    merged = np.concatenate([merged, normals.astype(np.float32)], axis=1)
    file_utils.make_dir_for_file(pts_file_npy)
    np.save(pts_file_npy, merged)
    if merged.shape[0] > min_pts_size:
        mesh_io.write_ply(
            pts_file_vis, merged[:, :3], normals=merged[:, 3:]
        )
    np.savez_compressed(
        hits_per_scan_file,
        hits_per_scan=np.asarray(hits_per_scan, np.int32),
    )
    return True


def sample_blensor(
    base_dir, dataset_dir, blensor_bin, dir_in, dir_out, dir_out_vis,
    num_scans_per_mesh_min, num_scans_per_mesh_max,
    scanner_noise_sigma_min, scanner_noise_sigma_max,
    num_processes=4, min_pts_size=0, device="cuda",
):
    """Full external-scanner stage: render scripts, run headless Blender,
    merge scans back into 04_pts (reference sample_blensor,
    make_dataset.py:242-380). Output conventions match the native scanner
    (datagen/make_dataset.py sample_scans): <stem>.xyz.npy (N, 6), pose
    npzs, hits-per-scan npz. The merge-back's normals are computed on
    ``device``."""
    ds = os.path.join(base_dir, dataset_dir)
    dir_in_abs = os.path.join(ds, dir_in)
    dir_out_abs = os.path.join(ds, dir_out)
    dir_vis_abs = os.path.join(ds, dir_out_vis)
    dir_pcd_abs = os.path.join(ds, "04_pcd")
    dir_raw_abs = os.path.join(ds, "04_pts_raw")
    dir_loc_abs = os.path.join(ds, "04_pts_locations")
    dir_rot_abs = os.path.join(ds, "04_pts_rotations")
    dir_hits_abs = os.path.join(ds, "04_hits_per_scan")
    for d in (dir_out_abs, dir_vis_abs, dir_raw_abs, dir_loc_abs,
              dir_rot_abs, dir_hits_abs):
        os.makedirs(d, exist_ok=True)

    scripts = write_blensor_scripts(
        base_dir, dataset_dir, dir_in, "04_pcd", "04_blensor_scripts",
        num_scans_per_mesh_min, num_scans_per_mesh_max,
        scanner_noise_sigma_min, scanner_noise_sigma_max,
    )
    # incremental re-runs skip meshes whose scans are up to date (the
    # reference guards the BlenSor stage the same way, make_dataset.py:
    # 339-341) — a headless-Blender run is minutes per mesh
    stale = [
        s for s, mesh_file, stem, n_scans in scripts
        if file_utils.call_necessary(
            [mesh_file, s], _expected_scan_files(dir_pcd_abs, stem, n_scans)
        )
    ]
    if stale:
        run_blensor(blensor_bin, stale, num_processes)

    call_params = []
    for f in sorted(os.listdir(dir_in_abs)):
        if not f.endswith(".ply"):
            continue
        stem = f[:-4]
        mesh_file = os.path.join(dir_in_abs, f)
        locations, rotations, sigma = scan_poses(
            mesh_file, num_scans_per_mesh_min, num_scans_per_mesh_max,
            scanner_noise_sigma_min, scanner_noise_sigma_max,
        )
        all_files = _expected_scan_files(
            dir_pcd_abs, stem, len(locations)
        )
        # keep scan index <-> pose pairing when scans are missing (a
        # dropped file must drop its pose too, or every later scan gets
        # the previous scan's inverse transform)
        present = [i for i, p in enumerate(all_files) if os.path.isfile(p)]
        pcd_files = [all_files[i] for i in present]
        scan_locations = [locations[i] for i in present]
        scan_rotations = [rotations[i] for i in present]
        if not pcd_files:
            print(f"no BlenSor scans found for {stem}")
            continue
        out_npy = os.path.join(dir_out_abs, stem + ".xyz.npy")
        out_vis = os.path.join(dir_vis_abs, stem + ".xyz.ply")
        out_raw = os.path.join(dir_raw_abs, stem + ".xyz.npz")
        out_hits = os.path.join(dir_hits_abs, stem + ".npz")
        np.savez_compressed(
            os.path.join(dir_loc_abs, stem + ".npz"), locations=locations
        )
        np.savez_compressed(
            os.path.join(dir_rot_abs, stem + ".npz"), rotations=rotations
        )
        if file_utils.call_necessary(
            pcd_files + [mesh_file], [out_npy, out_raw, out_hits]
        ):
            call_params.append((
                pcd_files, mesh_file, out_raw, out_npy, out_vis,
                scan_locations, scan_rotations, out_hits, min_pts_size,
            ))
    # merge runs in-process: the closest-point stage runs on the device
    for p in call_params:
        pcd_files_to_pts(*p, device=device)
