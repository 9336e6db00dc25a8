"""Synthetic analytic-SDF datasets (sphere / box / torus) (a copy of
``points2surf_tpu/datagen/synthetic.py``).

Generates datasets in the reference directory layout (SURVEY §2.2) with
exactly known signed distances — used for integration tests and for
validating the reconstruction stack independently of training data quality
(the role of the reference's ``reconstruct_gt`` self-test,
make_dataset.py:649-712). Sign convention: positive inside (matches
trimesh.proximity.signed_distance used by the reference datagen).
"""

from __future__ import annotations

import os

import numpy as np

from points2surf_tpu_torch.utils import mesh_io


def _sphere_sdf(p, radius=0.5):
    return radius - np.linalg.norm(p, axis=-1)


def _box_sdf(p, half=0.4):
    q = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return -(outside + inside)  # positive inside


def _torus_sdf(p, major=0.45, minor=0.2):
    xy = np.linalg.norm(p[..., :2], axis=-1)
    q = np.stack([xy - major, p[..., 2]], axis=-1)
    return minor - np.linalg.norm(q, axis=-1)


_SDFS = {"sphere": _sphere_sdf, "box": _box_sdf, "torus": _torus_sdf}


def _sample_surface(kind: str, n: int, rng: np.random.RandomState):
    if kind == "sphere":
        v = rng.randn(n, 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return (v * 0.5).astype(np.float32)
    if kind == "box":
        face = rng.randint(0, 6, n)
        uv = rng.uniform(-0.4, 0.4, (n, 2))
        pts = np.zeros((n, 3), np.float32)
        axis = face // 2
        sign = np.where(face % 2 == 0, 0.4, -0.4)
        for a in range(3):
            sel = axis == a
            others = [i for i in range(3) if i != a]
            pts[sel, a] = sign[sel]
            pts[sel, others[0]] = uv[sel, 0]
            pts[sel, others[1]] = uv[sel, 1]
        return pts
    if kind == "torus":
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        r = 0.45 + 0.2 * np.cos(v)
        return np.stack(
            [r * np.cos(u), r * np.sin(u), 0.2 * np.sin(v)], axis=1
        ).astype(np.float32)
    raise ValueError(kind)


def make_synthetic_dataset(
    out_dir: str,
    shapes=("sphere", "box"),
    n_points: int = 8192,
    n_query: int = 2000,
    noise_sigma: float = 0.0,
    far_ratio: float = 0.1,
    query_band: float = 0.1,
    seed: int = 0,
):
    """Write a reference-layout dataset with analytic GT signed distances.

    Query points: (1 - far_ratio) near the surface (within ±query_band
    along the normal direction) + far_ratio uniform in the cube, mirroring
    the reference's GT sampling strategy (sdf.py:288-315).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "04_pts"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "05_query_pts"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "05_query_dist"), exist_ok=True)

    names = []
    for kind in shapes:
        name = f"synthetic_{kind}"
        names.append(name)
        pts = _sample_surface(kind, n_points, rng)
        if noise_sigma > 0:
            pts = pts + rng.randn(*pts.shape).astype(np.float32) * noise_sigma
        np.save(os.path.join(out_dir, "04_pts", name + ".xyz.npy"), pts)

        n_far = int(n_query * far_ratio)
        n_near = n_query - n_far
        base = _sample_surface(kind, n_near, rng)
        offset = rng.uniform(-query_band, query_band, (n_near, 1)).astype(
            np.float32
        )
        direction = rng.randn(n_near, 3).astype(np.float32)
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        near = base + offset * direction
        far = rng.uniform(-0.5, 0.5, (n_far, 3)).astype(np.float32)
        query = np.concatenate([far, near], axis=0)
        dist = _SDFS[kind](query).astype(np.float32)
        np.save(os.path.join(out_dir, "05_query_pts", name + ".ply.npy"),
                query.astype(np.float32))
        np.save(os.path.join(out_dir, "05_query_dist", name + ".ply.npy"),
                dist)

        # GT mesh for metric comparison, via our own isosurface stack
        from points2surf_tpu_torch.ops.marching_cubes import (
            marching_tetrahedra)

        res = 64
        lin = np.linspace(-1, 1, res, dtype=np.float32)
        x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
        grid = np.stack([x, y, z], axis=-1)
        vol = _SDFS[kind](grid).astype(np.float32)
        v, f = marching_tetrahedra(vol, 0.0)
        v = v / (res - 1) * 2.0 - 1.0
        os.makedirs(os.path.join(out_dir, "03_meshes"), exist_ok=True)
        mesh_io.write_ply(
            os.path.join(out_dir, "03_meshes", name + ".ply"), v, f
        )

    with open(os.path.join(out_dir, "trainset.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(out_dir, "valset.txt"), "w") as f:
        f.write(names[0] + "\n")
    with open(os.path.join(out_dir, "testset.txt"), "w") as f:
        f.write(names[0] + "\n")
    return names
