"""Offline dataset factory: watertight meshes -> training data (counterpart
of ``points2surf_tpu/datagen/make_dataset.py``).

Re-implements the reference's 8-stage pipeline (make_dataset.py:731-850)
with the same numbered directory layout and per-file incremental-build
resumability (``call_necessary``):

  00_base_meshes -> 01_base_meshes_ply -> 02_meshes_cleaned -> 03_meshes
  -> 04_pts (virtual scanning) -> 05_query_{pts,dist,vis} -> split files

Differences by design:
* virtual scanning runs on the device raycaster by default
  (datagen/scanner.py); the BlenSor/Blender external path is preserved as
  ``scanner='blensor'`` with the same script-template interface.
* GT signed distances run on the device (ops/meshdist) instead of
  trimesh.proximity (which needs ~8 GB RAM per 3k queries).

The device stages (scanning, GT distances) run serially in this process on
``device``; the convert, clean and normalize stages are host-only process
pools whose spawned workers touch no device.
"""

from __future__ import annotations

import configparser
import os
import shutil

import numpy as np

from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.utils import file_utils, mesh_io
from points2surf_tpu_torch.utils.mesh import Mesh
from points2surf_tpu_torch.utils.mp import start_process_pool


# ------------------------------------------------------------ stages ----


def _convert_mesh(file_in, file_out):
    v, f = mesh_io.load_mesh(file_in)
    mesh_io.write_ply(file_out, v, f)


def convert_meshes(in_dir_abs, out_dir_abs, target_file_type=".ply",
                   num_processes=8):
    """Format conversion (reference make_dataset.py:42-68). OFF/PLY in,
    PLY out."""
    os.makedirs(out_dir_abs, exist_ok=True)
    mesh_files = []
    for root, _, files in os.walk(in_dir_abs, topdown=True):
        mesh_files += [os.path.join(root, f) for f in files]
    mesh_files = [f for f in mesh_files if f[-4:] in (".off", ".ply")]
    calls = []
    for f in mesh_files:
        out = os.path.join(
            out_dir_abs, os.path.basename(f)[:-4] + target_file_type
        )
        if file_utils.call_necessary(f, out):
            calls.append((f, out))
    start_process_pool(_convert_mesh, calls, num_processes)


def _clean_mesh(file_in, file_out, num_max_faces=None, enforce_solid=True):
    """Cleanup + watertightness gate (reference make_dataset.py:383-414).

    Unrepairable non-solids are silently skipped (quarantined later by
    clean_up_broken_inputs)."""
    try:
        v, f = mesh_io.load_mesh(file_in)
    except Exception as e:
        print(f"skipping unreadable mesh {file_in}: {e}")
        return
    mesh = Mesh(v, f).cleaned()
    if enforce_solid and not mesh.is_watertight():
        return
    mesh = mesh.fixed_inversion()
    if num_max_faces is not None and len(mesh.faces) >= num_max_faces:
        print(
            f"skipping {os.path.basename(file_in)}: {len(mesh.faces)} faces "
            f">= num_max_faces {num_max_faces} (raise --num_max_faces to "
            f"keep it; high-res thin-feature meshes commonly exceed 50k)"
        )
        return
    mesh_io.write_ply(file_out, mesh.vertices, mesh.faces)


def clean_meshes(base_dir, dataset_dir, dir_in_meshes, dir_out,
                 num_processes, num_max_faces=None, enforce_solid=True):
    dir_in_abs = os.path.join(base_dir, dataset_dir, dir_in_meshes)
    dir_out_abs = os.path.join(base_dir, dataset_dir, dir_out)
    os.makedirs(dir_out_abs, exist_ok=True)
    calls = []
    for f in sorted(os.listdir(dir_in_abs)):
        fi = os.path.join(dir_in_abs, f)
        fo = os.path.join(dir_out_abs, f)
        if os.path.isfile(fi) and file_utils.call_necessary(fi, fo):
            calls.append((fi, fo, num_max_faces, enforce_solid))
    start_process_pool(_clean_mesh, calls, num_processes)


def _normalize_mesh(file_in, file_out):
    v, f = mesh_io.load_mesh(file_in)
    mesh = Mesh(v, f)
    lo, hi = mesh.bounds()
    if float((hi - lo).min()) == 0.0:
        return
    # translate to origin, scale longest extent to 1 (unit cube, reference
    # make_dataset.py:71-88 — note the reference scales extents to 1, i.e.
    # coordinates in (-0.5, 0.5)... it scales by 1/extent.max(), max
    # extent becomes 1)
    center = (lo + hi) * 0.5
    scale = 1.0 / float((hi - lo).max())
    out = Mesh(((v - center) * scale).astype(np.float32), f)
    mesh_io.write_ply(file_out, out.vertices, out.faces)


def normalize_meshes(base_dir, in_dir, out_dir, dataset_dir,
                     num_processes=1):
    in_dir_abs = os.path.join(base_dir, dataset_dir, in_dir)
    out_dir_abs = os.path.join(base_dir, dataset_dir, out_dir)
    os.makedirs(out_dir_abs, exist_ok=True)
    calls = []
    for f in sorted(os.listdir(in_dir_abs)):
        fi = os.path.join(in_dir_abs, f)
        fo = os.path.join(out_dir_abs, f)
        if os.path.isfile(fi) and file_utils.call_necessary(fi, fo):
            calls.append((fi, fo))
    start_process_pool(_normalize_mesh, calls, num_processes)


def sample_scans(
    base_dir, dataset_dir, dir_in, dir_out, dir_out_vis,
    num_scans_per_mesh_min, num_scans_per_mesh_max,
    scanner_noise_sigma_min, scanner_noise_sigma_max,
    min_pts_size=0, device="cuda",
):
    """Virtual scanning on ``device`` (replaces sample_blensor,
    make_dataset.py:242-380). Writes 04_pts/<name>.xyz.npy as (N, 6)
    float32 (xyz + normals, the 2025 reference layout, make_dataset.py:232)
    plus scanner pose npzs and hits-per-scan like the reference."""
    from points2surf_tpu_torch.datagen import scanner

    dir_in_abs = os.path.join(base_dir, dataset_dir, dir_in)
    dir_out_abs = os.path.join(base_dir, dataset_dir, dir_out)
    dir_vis_abs = os.path.join(base_dir, dataset_dir, dir_out_vis)
    dir_loc_abs = os.path.join(base_dir, dataset_dir, "04_pts_locations")
    dir_rot_abs = os.path.join(base_dir, dataset_dir, "04_pts_rotations")
    dir_hits_abs = os.path.join(base_dir, dataset_dir, "04_hits_per_scan")
    for d in (dir_out_abs, dir_vis_abs, dir_loc_abs, dir_rot_abs,
              dir_hits_abs):
        os.makedirs(d, exist_ok=True)

    for f in sorted(os.listdir(dir_in_abs)):
        if not f.endswith(".ply"):
            continue
        mesh_file = os.path.join(dir_in_abs, f)
        out_npy = os.path.join(dir_out_abs, f[:-4] + ".xyz.npy")
        out_vis = os.path.join(dir_vis_abs, f[:-4] + ".xyz")
        out_loc = os.path.join(dir_loc_abs, f[:-4] + ".npz")
        out_rot = os.path.join(dir_rot_abs, f[:-4] + ".npz")
        out_hits = os.path.join(dir_hits_abs, f[:-4] + ".npz")
        if not file_utils.call_necessary(
            mesh_file, [out_npy, out_loc, out_rot, out_hits]
        ):
            continue
        v, faces = mesh_io.load_mesh(mesh_file)
        mesh = Mesh(v, faces)
        locations, rotations, sigma = scanner.scan_poses(
            mesh_file, num_scans_per_mesh_min, num_scans_per_mesh_max,
            scanner_noise_sigma_min, scanner_noise_sigma_max,
        )
        pts, normals, hits = scanner.scan_mesh(
            mesh, locations, rotations, sigma,
            seed=file_utils.filename_to_hash(mesh_file), device=device,
        )
        if pts.shape[0] < max(min_pts_size, 1):
            print(f"scan produced too few points for {f}: {pts.shape[0]}")
            continue
        np.save(out_npy, np.concatenate([pts, normals], axis=1))
        mesh_io.write_xyz(out_vis, pts, normals=normals)
        np.savez_compressed(out_loc, locations=locations)
        np.savez_compressed(out_rot, rotations=rotations)
        np.savez_compressed(out_hits, hits_per_scan=np.asarray(hits))


def get_query_pts_for_mesh(mesh: Mesh, num_query_pts: int,
                           patch_radius: float, far_query_pts_ratio=0.1,
                           rng=None):
    """Near-surface ± uniform offset + far uniform-cube query points
    (reference sdf.py:288-315)."""
    if rng is None:
        rng = np.random.RandomState()
    num_far = int(num_query_pts * far_query_pts_ratio)
    num_close = num_query_pts - num_far
    samples, face_ids = mesh.sample_surface(num_close, rng)
    normals = mesh.face_normals[face_ids]
    offset = ((rng.random_sample(num_close) - 0.5) * 2.0 * patch_radius)
    close = samples + offset[:, None] * normals
    far = rng.random_sample((num_far, 3)) - 0.5
    return np.concatenate([far, close.astype(np.float64)], axis=0)


def _get_and_save_query_pts(
    file_in_mesh, file_out_query_pts, file_out_query_dist,
    file_out_query_vis, num_query_pts, patch_radius,
    far_query_pts_ratio=0.1, debug=False, device="cuda",
):
    from points2surf_tpu_torch.ops.meshdist import signed_distance

    rng = np.random.RandomState(file_utils.filename_to_hash(file_in_mesh))
    v, f = mesh_io.load_mesh(file_in_mesh)
    mesh = Mesh(v, f)
    query = get_query_pts_for_mesh(
        mesh, num_query_pts, patch_radius, far_query_pts_ratio, rng
    )
    np.save(file_out_query_pts, query.astype(np.float32))

    dist = signed_distance(mesh.vertices, mesh.faces,
                           query.astype(np.float32), device=device)
    dist = np.nan_to_num(dist, nan=0.0, posinf=1.0, neginf=1.0)
    dist = np.clip(dist, -1.0, 1.0)  # reference make_dataset.py:467-473
    np.save(file_out_query_dist, dist.astype(np.float32))

    if debug and file_out_query_vis is not None:
        from points2surf_tpu_torch.infer.evaluator import (
            visualize_query_points)

        visualize_query_points(query, dist, file_out_query_vis)


def get_query_pts_dist_ms(
    base_dir, dataset_dir, dir_in_mesh, dir_out_query_pts_ms,
    dir_out_query_dist_ms, dir_out_query_vis, patch_radius,
    num_query_pts=2000, far_query_pts_ratio=0.1, debug=False, device="cuda",
):
    """GT query points + signed distances (reference make_dataset.py:481-538).
    Runs serially in-process: the distance math runs on ``device``."""
    d_mesh = os.path.join(base_dir, dataset_dir, dir_in_mesh)
    d_pts = os.path.join(base_dir, dataset_dir, dir_out_query_pts_ms)
    d_dist = os.path.join(base_dir, dataset_dir, dir_out_query_dist_ms)
    d_vis = os.path.join(base_dir, dataset_dir, dir_out_query_vis)
    os.makedirs(d_pts, exist_ok=True)
    os.makedirs(d_dist, exist_ok=True)
    if debug:
        os.makedirs(d_vis, exist_ok=True)
    for f in sorted(os.listdir(d_mesh)):
        if not f.endswith(".ply"):
            continue
        fi = os.path.join(d_mesh, f)
        fo_pts = os.path.join(d_pts, f + ".npy")
        fo_dist = os.path.join(d_dist, f + ".npy")
        fo_vis = os.path.join(d_vis, f + ".ply")
        if file_utils.call_necessary(fi, [fo_pts, fo_dist]):
            _get_and_save_query_pts(
                fi, fo_pts, fo_dist, fo_vis, num_query_pts, patch_radius,
                far_query_pts_ratio, debug, device,
            )


def make_dataset_splits(base_dir, dataset_dir, final_out_dir, seed=42,
                        only_test_set=False, testset_ratio=0.1):
    """trainset/valset/testset files; test = clamp(10%, 3, 100), val
    mirrors test (reference make_dataset.py:541-577)."""
    import random as _random

    rnd = _random.Random(seed)
    out_abs = os.path.join(base_dir, dataset_dir, final_out_dir)
    files = [
        f for f in os.listdir(out_abs)
        if os.path.isfile(os.path.join(out_abs, f)) and f.endswith(".npy")
    ]
    stems = [f[:-8] for f in files]
    if not stems:
        raise ValueError(f"Dataset is empty! {out_abs}")
    if only_test_set:
        test = list(stems)
    else:
        test = rnd.sample(stems, max(3, min(int(testset_ratio * len(stems)),
                                            100)))
    train = sorted(set(stems) - set(test))
    test = sorted(test)
    with open(os.path.join(base_dir, dataset_dir, "testset.txt"), "w") as f:
        f.write("\n".join(test))
    if not only_test_set:
        with open(
            os.path.join(base_dir, dataset_dir, "trainset.txt"), "w"
        ) as f:
            f.write("\n".join(train))
    with open(os.path.join(base_dir, dataset_dir, "valset.txt"), "w") as f:
        f.write("\n".join(test))  # validate the test set by default


def clean_up_broken_inputs(base_dir, dataset_dir, final_out_dir,
                           final_out_extension, clean_up_dirs,
                           broken_dir="broken"):
    """Quarantine inputs whose final outputs are missing
    (reference make_dataset.py:580-617)."""
    out_abs = os.path.join(base_dir, dataset_dir, final_out_dir)
    if not os.path.isdir(out_abs):
        return
    final_files = [
        f for f in os.listdir(out_abs)
        if os.path.isfile(os.path.join(out_abs, f))
        and (final_out_extension is None
             or f.endswith(final_out_extension))
    ]
    if not final_files:
        print(f'Warning: Output dir "{out_abs}" is empty')
        return
    ok_stems = {f.split(".", 1)[0] for f in final_files}
    for d in clean_up_dirs:
        dir_abs = os.path.join(base_dir, dataset_dir, d)
        if not os.path.isdir(dir_abs):
            continue
        for f in os.listdir(dir_abs):
            src = os.path.join(dir_abs, f)
            if not os.path.isfile(src):
                continue
            if f.split(".", 1)[0] not in ok_stems:
                broken_abs = os.path.join(base_dir, dataset_dir, broken_dir, d)
                os.makedirs(broken_abs, exist_ok=True)
                shutil.move(src, os.path.join(broken_abs, f))


def read_settings(base_dir, dataset_dir):
    """settings.ini (reference make_dataset.py:715-758)."""
    config = configparser.ConfigParser()
    config.read(os.path.join(base_dir, dataset_dir, "settings.ini"))
    g = config["general"] if "general" in config else {}

    def geti(key, default):
        return int(g.get(key, default))

    def getf(key, default):
        return float(g.get(key, default))

    return {
        "only_for_evaluation": bool(geti("only_for_evaluation", 0)),
        "grid_resolution": geti("grid_resolution", 256),
        "epsilon": geti("epsilon", 5),
        "num_scans_per_mesh_min": geti("num_scans_per_mesh_min", 5),
        "num_scans_per_mesh_max": geti("num_scans_per_mesh_max", 30),
        "scanner_noise_sigma_min": getf("scanner_noise_sigma_min", 0.0),
        "scanner_noise_sigma_max": getf("scanner_noise_sigma_max", 0.05),
    }


def get_patch_radius(grid_res, epsilon):
    """(1 + epsilon) / grid_res (reference point_cloud.py:166-167)."""
    return (1.0 + epsilon) / grid_res


def make_dataset(dataset_name, base_dir="datasets", num_processes=4,
                 num_query_pts=2000, num_max_faces=50000,
                 far_query_pts_ratio=0.1, debug=False,
                 scanner="native", blensor_bin=None, device="cuda"):
    """Full pipeline driver (reference make_dataset.py:731-850).

    scanner: 'native' = on-device raycaster (default); 'blensor' = external
    BlenSor/Blender subprocesses + scan merge-back (requires blensor_bin),
    the reference's original path. The device stages run on ``device``,
    checked before any stage runs.
    """
    device = require_cuda(device)
    settings = read_settings(base_dir, dataset_name)
    patch_radius = get_patch_radius(
        settings["grid_resolution"], settings["epsilon"]
    )
    only_eval = settings["only_for_evaluation"]

    ds = os.path.join(base_dir, dataset_name)
    clean_up_broken_inputs(
        base_dir, dataset_name, "00_base_meshes", None,
        ["00_base_meshes"],
    )
    convert_meshes(
        os.path.join(ds, "00_base_meshes"),
        os.path.join(ds, "01_base_meshes_ply"),
        ".ply", num_processes,
    )
    clean_meshes(base_dir, dataset_name, "01_base_meshes_ply",
                 "02_meshes_cleaned", num_processes,
                 num_max_faces=num_max_faces)
    clean_up_broken_inputs(
        base_dir, dataset_name, "02_meshes_cleaned", ".ply",
        ["00_base_meshes", "01_base_meshes_ply"],
    )
    normalize_meshes(base_dir, "02_meshes_cleaned", "03_meshes",
                     dataset_name, num_processes)
    if scanner == "blensor":
        from points2surf_tpu_torch.datagen.blensor import sample_blensor

        if not blensor_bin:
            raise ValueError("scanner='blensor' requires blensor_bin")
        sample_blensor(
            base_dir, dataset_name, blensor_bin,
            "03_meshes", "04_pts", "04_pts_vis",
            settings["num_scans_per_mesh_min"],
            settings["num_scans_per_mesh_max"],
            settings["scanner_noise_sigma_min"],
            settings["scanner_noise_sigma_max"],
            num_processes=num_processes, device=device,
        )
    else:
        sample_scans(
            base_dir, dataset_name, "03_meshes", "04_pts", "04_pts_vis",
            settings["num_scans_per_mesh_min"],
            settings["num_scans_per_mesh_max"],
            settings["scanner_noise_sigma_min"],
            settings["scanner_noise_sigma_max"], device=device,
        )
    clean_up_broken_inputs(
        base_dir, dataset_name, "04_pts", ".xyz.npy",
        ["00_base_meshes", "01_base_meshes_ply", "02_meshes_cleaned",
         "03_meshes"],
    )
    if not only_eval:
        get_query_pts_dist_ms(
            base_dir, dataset_name, "03_meshes", "05_query_pts",
            "05_query_dist", "05_query_vis", patch_radius,
            num_query_pts, far_query_pts_ratio, debug, device,
        )
        clean_up_broken_inputs(
            base_dir, dataset_name, "05_query_pts", ".npy",
            ["00_base_meshes", "01_base_meshes_ply", "02_meshes_cleaned",
             "03_meshes", "04_pts", "05_query_dist"],
        )
    make_dataset_splits(base_dir, dataset_name, "04_pts",
                        only_test_set=only_eval)


def write_dataset_csv(base_dir, dataset_dir, pts_dir="04_pts",
                      out_file="dataset_stats.csv"):
    """Per-shape point-count stats CSV (reference make_dataset.py:620-646)."""
    pts_abs = os.path.join(base_dir, dataset_dir, pts_dir)
    rows = ["pts_file,num_points"]
    for f in sorted(os.listdir(pts_abs)):
        if f.endswith(".npy"):
            n = np.load(os.path.join(pts_abs, f), mmap_mode="r").shape[0]
            rows.append(f"{f},{n}")
    csv_file = os.path.join(base_dir, dataset_dir, out_file)
    with open(csv_file, "w") as fh:
        fh.write("\n".join(rows))
    return csv_file


def reconstruct_gt(base_dir, dataset_dir, grid_resolution=128, sigma=5,
                   certainty_threshold=13, num_query_pts=100000,
                   far_query_pts_ratio=0.1, device="cuda"):
    """GT round-trip self-test: mesh the ground-truth SDF samples to
    validate splat/propagate/marching independently of any network
    (reference make_dataset.py:649-712). Writes 06_reconstruction_gt/.
    The distances and the volume are computed on ``device``."""
    from points2surf_tpu_torch.infer.meshing import implicit_surface_to_mesh
    from points2surf_tpu_torch.ops.meshdist import signed_distance

    d_mesh = os.path.join(base_dir, dataset_dir, "03_meshes")
    d_out = os.path.join(base_dir, dataset_dir, "06_reconstruction_gt")
    os.makedirs(d_out, exist_ok=True)
    patch_radius = get_patch_radius(grid_resolution, 3)
    for f in sorted(os.listdir(d_mesh)):
        if not f.endswith(".ply"):
            continue
        mesh_file = os.path.join(d_mesh, f)
        vol_out = os.path.join(d_out, f[:-4] + ".off")
        mesh_out = os.path.join(d_out, f[:-4] + ".ply")
        if not file_utils.call_necessary(mesh_file, [mesh_out]):
            continue
        rng = np.random.RandomState(file_utils.filename_to_hash(mesh_file))
        v, faces = mesh_io.load_mesh(mesh_file)
        mesh = Mesh(v, faces)
        query = get_query_pts_for_mesh(
            mesh, num_query_pts, patch_radius, far_query_pts_ratio, rng
        ).astype(np.float32)
        dist = signed_distance(mesh.vertices, mesh.faces, query,
                               device=device)
        dist = np.clip(np.nan_to_num(dist, nan=0.0, posinf=1.0, neginf=1.0),
                       -1.0, 1.0)
        implicit_surface_to_mesh(
            dist.astype(np.float32), query, vol_out, mesh_out,
            grid_resolution, sigma, certainty_threshold, device=device,
        )
