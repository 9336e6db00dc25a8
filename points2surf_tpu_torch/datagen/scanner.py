"""Virtual ToF scanner on the device (counterpart of
``points2surf_tpu/datagen/scanner.py``).

Replaces the reference's BlenSor/Blender subprocess scanning
(make_dataset.py:242-380 + blensor_script_template.py) with an on-device
raycaster (``ops/raycast.py``). The scan geometry mirrors the reference's
ToF setup: a 176x144-ray frustum with 43.6°x34.6° lens angles, the object
placed ~4 units in front of the camera with small lateral jitter and a
uniform random rotation per scan, per-mesh noise sigma, and scan count /
poses drawn from a RandomState seeded by the filename hash — so pose
sequences are IDENTICAL to what the reference would feed BlenSor
(make_dataset.py:303-315).

Instead of posing the object and un-transforming hit points afterwards
(reference _blensor_vs_to_ws, make_dataset.py:124-144), rays are cast in
model space directly (camera transformed by the inverse pose), so merged
clouds land in model space with no round-trip error. Gaussian noise is
applied along the ray like BlenSor's ToF model. Per-point normals come from
the hit triangle (the reference approximates them with the nearest face
after merging, make_dataset.py:147-239).
"""

from __future__ import annotations

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.ops import raycast
from points2surf_tpu_torch.utils import file_utils
from points2surf_tpu_torch.utils.mesh import Mesh

TOF_RES_X = 176
TOF_RES_Y = 144
LENS_ANGLE_W = 43.6  # degrees
LENS_ANGLE_H = 34.6
MAX_DISTANCE = 10.0


def _quat_to_rotmat_np(q):
    w, x, y, z = q
    s = 2.0 / np.dot(q, q)
    return np.array(
        [
            [1 - (y * y + z * z) * s, (x * y - z * w) * s, (x * z + y * w) * s],
            [(x * y + z * w) * s, 1 - (x * x + z * z) * s, (y * z - x * w) * s],
            [(x * z - y * w) * s, (y * z + x * w) * s, 1 - (x * x + y * y) * s],
        ],
        np.float64,
    )


def _random_quaternion(rand3):
    """trimesh.transformations.random_quaternion(rand) clone (w,x,y,z)...

    Returns [x*sin(t1), x*cos(t1)... ] using Shoemake's method in the
    (w, x, y, z) order that trimesh uses for the object pose
    (make_dataset.py:315).
    """
    r1 = np.sqrt(1.0 - rand3[0])
    r2 = np.sqrt(rand3[0])
    t1 = 2.0 * np.pi * rand3[1]
    t2 = 2.0 * np.pi * rand3[2]
    return np.array(
        [np.cos(t2) * r2, np.sin(t1) * r1, np.cos(t1) * r1, np.sin(t2) * r2]
    )


def _frustum_dirs(res_x: int = TOF_RES_X, res_y: int = TOF_RES_Y) -> np.ndarray:
    """(R, 3) unit ray directions of the ToF grid; camera looks along +y."""
    half_w = np.tan(np.deg2rad(LENS_ANGLE_W) / 2.0)
    half_h = np.tan(np.deg2rad(LENS_ANGLE_H) / 2.0)
    xs = np.linspace(-half_w, half_w, res_x)
    zs = np.linspace(-half_h, half_h, res_y)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    d = np.stack([gx.ravel(), np.ones(gx.size), gz.ravel()], axis=1)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def scan_poses(mesh_file: str, num_scans_min: int, num_scans_max: int,
               sigma_min: float, sigma_max: float):
    """Deterministic per-mesh scan poses, byte-identical RNG consumption to
    the reference (make_dataset.py:303-315)."""
    rnd = np.random.RandomState(file_utils.filename_to_hash(mesh_file))
    num_scans = rnd.randint(num_scans_min, num_scans_max + 1)
    noise_sigma = rnd.rand() * (sigma_max - sigma_min) + sigma_min
    locations = []
    rotations = []
    for _ in range(num_scans):
        loc = (rnd.rand(3) * 2.0 - 1.0) * np.array([0.1, 1.0, 0.1])
        loc[1] += 4.0
        rot = _random_quaternion(rnd.rand(3))
        locations.append(loc)
        rotations.append(rot)
    return np.asarray(locations), np.asarray(rotations), noise_sigma


def scan_mesh(
    mesh: Mesh,
    locations: np.ndarray,
    rotations: np.ndarray,
    noise_sigma: float,
    seed: int = 0,
    tri_chunk: int = 2048,
    res_x: int = TOF_RES_X,
    res_y: int = TOF_RES_Y,
    device="cuda",
):
    """Simulate all scans; returns (points (N,3), normals (N,3),
    hits_per_scan list) — points in MODEL space.

    Each scan is cast on ``device`` and its ``t`` and triangle ids fetched
    once. The noise is drawn on the host for all rays, hit or not, from
    ``np.random.RandomState(seed)``, as the JAX package draws it."""
    dev = require_cuda(device)
    ta, tb, tc, n_tris = raycast.pad_triangles(
        mesh.vertices, mesh.faces, tri_chunk, dev
    )
    face_normals = mesh.face_normals
    dirs_cam = _frustum_dirs(res_x, res_y)
    rng = np.random.RandomState(seed)

    pts_out = []
    normals_out = []
    hits_per_scan = []
    for loc, quat in zip(locations, rotations):
        rot = _quat_to_rotmat_np(quat)
        # world pt = R x + loc; ray (0, d) in camera/world frame ->
        # model space: origin = R^T (0 - loc), dir = R^T d
        origin_ms = rot.T @ (-loc)
        dirs_ms = (dirs_cam @ rot).astype(np.float32)  # (R @ rot) == rot.T d
        origins_ms = np.broadcast_to(
            origin_ms.astype(np.float32), dirs_ms.shape
        )
        t, tri_id = raycast.raycast_padded(
            torch.as_tensor(origin_ms.astype(np.float32), device=dev)
            .expand(dirs_ms.shape),
            torch.as_tensor(dirs_ms, device=dev),
            ta, tb, tc, n_tris, tri_chunk=tri_chunk,
        )
        t = t.cpu().numpy()
        tri_id = tri_id.cpu().numpy()
        hit = np.isfinite(t) & (t <= MAX_DISTANCE)
        if noise_sigma > 0:
            t = t + rng.randn(*t.shape).astype(np.float32) * noise_sigma
        pts = origins_ms + t[:, None] * dirs_ms
        pts_out.append(pts[hit].astype(np.float32))
        normals_out.append(face_normals[tri_id[hit]].astype(np.float32))
        hits_per_scan.append(int(hit.sum()))
    if pts_out:
        return (
            np.concatenate(pts_out),
            np.concatenate(normals_out),
            hits_per_scan,
        )
    return (
        np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.float32),
        hits_per_scan,
    )
