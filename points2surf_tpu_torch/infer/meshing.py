"""Implicit surface -> mesh (counterpart of
``points2surf_tpu/infer/meshing.py``): splat and sign propagation on the
device, marching tetrahedra on the host.

Reference: source/sdf.py:181-266. The volume (splat, optional seed filter,
iterative sign propagation, clamp) is built with torch on the device the
caller names (the card unless it asks for the CPU), fetched in float32, and
meshed by the C++ marching copy (``ops/marching_native.py``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.ops import marching_cubes, voxel
from points2surf_tpu_torch.utils import file_utils, mesh_io, trace


def _build_volume(query_pts, query_dist, n_valid, grid_res, sigma,
                  certainty_threshold, seed_filter=0):
    """(grid_res,)*3 float32 volume in [-1, 1] from query points and
    distances, tensors on their device; rows >= n_valid are ignored."""
    with trace.span("volume.splat"):
        vol = voxel.splat_to_volume(query_pts, query_dist, n_valid, grid_res)
        if seed_filter:
            # flood containment (experimental): drop isolated wrong-sign
            # seeds before propagation (ops/voxel.filter_seed_signs)
            vol = voxel.filter_seed_signs(vol, 3, seed_filter)
    with trace.span("volume.propagate"):
        vol = voxel.propagate_sign(vol, sigma, certainty_threshold)
        return torch.clamp(vol, -1.0, 1.0)


def _device_volume(query_pts_ms, query_dist_ms, grid_res, sigma,
                   certainty_threshold, seed_filter, device) -> np.ndarray:
    """Build the volume of host arrays on ``device`` and fetch it (f32)."""
    dev = require_cuda(device)
    with trace.span("volume.upload"), trace.blocking(dev, 2):
        pts = torch.as_tensor(np.asarray(query_pts_ms, np.float32),
                              device=dev)
        dist = torch.as_tensor(np.asarray(query_dist_ms, np.float32),
                               device=dev)
    vol = _build_volume(pts, dist, len(query_pts_ms), grid_res, sigma,
                        certainty_threshold, seed_filter)
    with trace.span("volume.fetch"), trace.blocking(dev):
        return vol.cpu().numpy()


def _write_debug_volume(query_pts_ms, query_dist_ms, volume_out_file):
    """Colored query-point debug volume (reference sdf.py:204-209)."""
    with trace.span("write.off"):
        dist_norm = query_dist_ms / max(float(np.abs(query_dist_ms).max()),
                                        1e-12)
        colors = np.zeros((dist_norm.shape[0], 3))
        neg = dist_norm < 0.0
        pos = dist_norm > 0.0
        colors[neg, 0] = np.abs(dist_norm[neg]) + 0.5
        colors[pos, 1] = dist_norm[pos] + 0.5
        mesh_io.write_off(
            volume_out_file, query_pts_ms, np.array([]), colors_vertex=colors
        )
    trace.count_sizes("write.bytes", volume_out_file)


def _extract_and_write(vol: np.ndarray, mc_out_file: str,
                       grid_res: int, query_pts_ms=None) -> bool:
    if vol.min() < 0.0 < vol.max():
        t0 = time.time()
        with trace.span("mesh.marching"):
            v, f = marching_cubes.extract_isosurface(vol, 0.0)
        print(f"Isosurface extraction took: {time.time() - t0}")
        if v.size == 0:
            print("Warning: isosurface extraction gives no result!")
            return False
        # voxel-index -> model space (reference sdf.py:224)
        v = (((v + 0.5) / float(grid_res)) - 0.5) * 2.0
        if query_pts_ms is not None and len(query_pts_ms):
            # flood diagnostic: near-surface sign errors can make sign
            # propagation flood "inside" far past the observed cloud. The
            # mesh is written either way (reference behavior); the warning
            # makes the failure visible at eval time instead of in the
            # comparison CSV.
            margin = 8.0 / grid_res
            lo = query_pts_ms.min(0) - margin
            hi = query_pts_ms.max(0) + margin
            overflow = float(
                np.maximum(lo - v.min(0), v.max(0) - hi).max()
            )
            if overflow > 0.0:
                print(
                    f"WARNING: reconstruction extends {overflow:.3f} "
                    f"(model units) beyond the queried volume for "
                    f"{mc_out_file} — likely sign-propagation flooding "
                    "from near-surface sign errors"
                )
        file_utils.make_dir_for_file(mc_out_file)
        with trace.span("write.mesh_ply"):
            mesh_io.write_ply(mc_out_file, v, f)
        trace.count_sizes("write.bytes", mc_out_file)
        return True
    print("Warning: volume for marching cubes contains no 0-level set!")
    return False


def seed_filter_from_env() -> int:
    """P2S_SEED_FILTER: opt-in flood-containment pre-pass strength (number
    of wrong-sign-neighbor votes needed to keep a seed; 0 = off). Validated
    and announced like the other eval levers."""
    raw = os.environ.get("P2S_SEED_FILTER")
    if raw is None:
        return 0
    try:
        value = int(raw)
    except ValueError:
        print(f"WARNING: P2S_SEED_FILTER={raw!r} is not an integer; "
              "seed filter stays off")
        return 0
    if value:
        print(f"eval lever: seed_filter={value} (P2S_SEED_FILTER)")
    return value


def _only_zeros(query_dist_ms) -> bool:
    return (float(np.max(query_dist_ms)) == 0.0
            and float(np.min(query_dist_ms)) == 0.0)


def implicit_surface_to_mesh(
    query_dist_ms: np.ndarray,
    query_pts_ms: np.ndarray,
    volume_out_file: str,
    mc_out_file: str,
    grid_res: int,
    sigma: int,
    certainty_threshold: int = 26,
    seed_filter: int = 0,
    device: torch.device | str = "cuda",
) -> bool:
    """Densify sparse SDF samples and extract the zero isosurface
    (reference sdf.py:181-230). Returns True when a mesh was written.

    ``seed_filter`` > 0 enables the experimental flood-containment
    pre-pass (ops/voxel.filter_seed_signs) before sign propagation. The
    volume is built on ``device``."""
    if _only_zeros(query_dist_ms):
        print(f"WARNING: implicit surface for {volume_out_file} "
              "contains only zeros")
        return False

    t0 = time.time()
    vol = _device_volume(query_pts_ms, query_dist_ms, grid_res, sigma,
                         certainty_threshold, seed_filter, device)
    print(f"Sign propagation took: {time.time() - t0}")

    _write_debug_volume(query_pts_ms, query_dist_ms, volume_out_file)
    return _extract_and_write(vol, mc_out_file, grid_res, query_pts_ms)


def implicit_surface_to_mesh_file(
    query_dist_ms_file, query_pts_ms_file,
    volume_out_file, mc_out_file, grid_res, sigma, certainty_threshold,
    seed_filter=0, device="cuda",
):
    query_dist_ms = np.load(query_dist_ms_file)
    query_pts_ms = np.load(query_pts_ms_file)
    implicit_surface_to_mesh(
        query_dist_ms, query_pts_ms,
        volume_out_file, mc_out_file, grid_res, sigma, certainty_threshold,
        seed_filter, device,
    )


def implicit_surface_to_mesh_directory(
    imp_surf_dist_ms_dir, query_pts_ms_dir,
    vol_out_dir, mesh_out_dir,
    grid_res, sigma, certainty_threshold, num_processes=1,
    shard=None, seed_filter=None, device="cuda",
):
    """Per-directory driver (reference sdf.py:241-266).

    One process, one device (a pool would contend for it): each shape's
    volume is built on ``device`` and fetched, and the host meshes it; the
    slow debug-volume OFF writes go to a writer thread, which does numpy
    and file IO only. ``num_processes`` is accepted for the reference's
    signature and not used.

    ``shard=(index, count)`` meshes a round-robin share of the directory
    (multi-host runs: each host meshes the shapes it reconstructed).

    ``seed_filter=None`` (the default) reads P2S_SEED_FILTER from the
    environment, so the flood-containment pre-pass can be enabled on any
    production eval without code changes.
    """
    from concurrent.futures import ThreadPoolExecutor

    if seed_filter is None:
        seed_filter = seed_filter_from_env()

    os.makedirs(vol_out_dir, exist_ok=True)
    os.makedirs(mesh_out_dir, exist_ok=True)

    dist_files = [
        f
        for f in sorted(os.listdir(imp_surf_dist_ms_dir))
        if os.path.isfile(os.path.join(imp_surf_dist_ms_dir, f))
        and f.endswith(".xyz.npy")
    ]
    if shard is not None and shard[1] > 1:
        dist_files = [
            f for i, f in enumerate(dist_files) if i % shard[1] == shard[0]
        ]

    with ThreadPoolExecutor(max_workers=2) as writer:
        write_futures = []
        for f in dist_files:
            dist_in = os.path.join(imp_surf_dist_ms_dir, f)
            pts_in = os.path.join(query_pts_ms_dir, f)
            vol_out = os.path.join(vol_out_dir, f[:-8] + ".off")
            mesh_out = os.path.join(mesh_out_dir, f[:-8] + ".ply")
            if not file_utils.call_necessary(
                [dist_in, pts_in], [vol_out, mesh_out]
            ):
                continue
            dist = np.load(dist_in)
            pts = np.load(pts_in)
            if _only_zeros(dist):
                print(f"WARNING: implicit surface for {vol_out} "
                      "contains only zeros")
                continue
            t0 = time.time()
            vol = _device_volume(pts, dist, grid_res, sigma,
                                 certainty_threshold, seed_filter, device)
            print(f"Sign propagation took: {time.time() - t0}")
            write_futures.append(
                writer.submit(_write_debug_volume, pts, dist, vol_out)
            )
            _extract_and_write(vol, mesh_out, grid_res, pts)
        for wf in write_futures:
            wf.result()
