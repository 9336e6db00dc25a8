"""Procedural watertight-mesh zoo for ABC-scale pipeline exercises (a copy
of ``points2surf_tpu/datagen/procedural.py``; it marches through the port's
C++ build of marching tetrahedra, which raises if it cannot be built).

The reference's flagship training set is ~5k ABC CAD meshes
(reference README.md:119, datasets/download_datasets_abc.py); with no
network egress in this environment, this module generates an arbitrarily
large family of DIVERSE watertight meshes to drive the full
datagen -> train -> reconstruct stack at that scale:

* ``csg``     — 1..4 random primitive SDFs (sphere / rounded box / torus /
                capsule / ellipsoid / cylinder) under smooth- or hard-min
                union, optionally carving one primitive out (genus
                variety), meshed with our marching tetrahedra.
* ``bumpy``   — subdivided icosahedron with a random low-frequency radial
                displacement field (organic star-shaped solids).
* ``hull``    — convex hull of a small random point set (polytopes,
                CAD-like flats and edges).

Every mesh is cleaned and watertightness-checked (utils/mesh.Mesh); rare
non-solid results are retried with a fresh seed, mirroring the
reference datagen's broken-input quarantine philosophy
(reference make_dataset.py:580-617).
"""

from __future__ import annotations

import os

import numpy as np

from points2surf_tpu_torch.ops.marching_cubes import extract_isosurface
from points2surf_tpu_torch.utils import mesh_io
from points2surf_tpu_torch.utils.mesh import Mesh

# ----------------------------------------------------------- SDF zoo ----
# convention: positive INSIDE (the trimesh/reference convention)


def _sd_sphere(p, r):
    return r - np.linalg.norm(p, axis=-1)


def _sd_ellipsoid(p, abc):
    # inexact (scaled-space) ellipsoid distance; fine for meshing
    k = np.linalg.norm(p / abc, axis=-1)
    k = np.maximum(k, 1e-9)
    return (1.0 - k) * np.min(abc)


def _sd_box(p, half, round_r=0.0):
    q = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return round_r - (outside + inside)


def _sd_torus(p, major, minor):
    xy = np.linalg.norm(p[..., :2], axis=-1)
    return minor - np.sqrt((xy - major) ** 2 + p[..., 2] ** 2)


def _sd_capsule(p, half_h, r):
    z = np.clip(p[..., 2], -half_h, half_h)
    q = p.copy()
    q[..., 2] -= z
    return r - np.linalg.norm(q, axis=-1)


def _sd_cylinder(p, half_h, r):
    d_r = np.linalg.norm(p[..., :2], axis=-1) - r
    d_z = np.abs(p[..., 2]) - half_h
    d = np.stack([d_r, d_z], axis=-1)
    outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
    inside = np.minimum(np.maximum(d_r, d_z), 0.0)
    return -(outside + inside)


def _random_primitive(rng):
    kind = rng.randint(0, 6)
    if kind == 0:
        r = rng.uniform(0.25, 0.55)
        return lambda p: _sd_sphere(p, r)
    if kind == 1:
        half = rng.uniform(0.18, 0.45, 3)
        round_r = rng.uniform(0.0, 0.06)
        return lambda p: _sd_box(p, half, round_r)
    if kind == 2:
        major = rng.uniform(0.3, 0.5)
        minor = rng.uniform(0.08, min(0.25, major - 0.05))
        return lambda p: _sd_torus(p, major, minor)
    if kind == 3:
        half_h = rng.uniform(0.15, 0.4)
        r = rng.uniform(0.12, 0.35)
        return lambda p: _sd_capsule(p, half_h, r)
    if kind == 4:
        abc = rng.uniform(0.2, 0.55, 3)
        return lambda p: _sd_ellipsoid(p, abc)
    half_h = rng.uniform(0.15, 0.45)
    r = rng.uniform(0.15, 0.4)
    return lambda p: _sd_cylinder(p, half_h, r)


def _random_rigid(rng, scale_lo=0.6, scale_hi=1.0):
    """Random rotation + translation + uniform scale as a point transform."""
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    t = rng.uniform(-0.25, 0.25, 3)
    s = rng.uniform(scale_lo, scale_hi)

    def xf(p):
        return (p - t) @ rot / s

    return xf, s


def _smooth_max(a, b, k):
    """Smooth union in positive-inside convention (smooth max)."""
    if k <= 0:
        return np.maximum(a, b)
    h = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b * h + a * (1 - h) + k * h * (1 - h)


def _csg_sdf(rng):
    n_parts = rng.randint(1, 5)
    parts = []
    for _ in range(n_parts):
        sd = _random_primitive(rng)
        xf, s = _random_rigid(rng)
        parts.append((sd, xf, s))
    smooth_k = float(rng.uniform(0.0, 0.08)) if rng.rand() < 0.5 else 0.0
    carve = rng.rand() < 0.35
    if carve:
        sd_c = _random_primitive(rng)
        xf_c, s_c = _random_rigid(rng, 0.4, 0.8)

    def sdf(p):
        d = None
        for sd, xf, s in parts:
            di = sd(xf(p)) * s
            d = di if d is None else _smooth_max(d, di, smooth_k)
        if carve:
            d = np.minimum(d, -sd_c(xf_c(p)) * s_c)
        return d

    return sdf


# ----------------------------------------------------- thin features ----
# Round-2 validation found the trained model's worst failures on shapes
# with THIN features (proc_00061-class Hausdorff outliers: spurious
# sign-error components on plates/rods; docs/VALIDATION.md). This family
# makes such features a first-class training style so the
# diversity-vs-pipeline diagnosis can be tested directly: plates, rods,
# and thin tori (2-5% of object extent), optionally attached to a blob.


def _thin_part(rng):
    kind = rng.randint(0, 3)
    if kind == 0:  # plate
        half = np.array([
            rng.uniform(0.2, 0.45), rng.uniform(0.2, 0.45),
            rng.uniform(0.015, 0.035),
        ])
        return lambda p: _sd_box(p, half, 0.0)
    if kind == 1:  # rod
        half_h = rng.uniform(0.25, 0.45)
        r = rng.uniform(0.015, 0.04)
        return lambda p: _sd_capsule(p, half_h, r)
    major = rng.uniform(0.3, 0.5)  # thin ring
    minor = rng.uniform(0.02, 0.045)
    return lambda p: _sd_torus(p, major, minor)


def _thin_sdf(rng):
    n_thin = rng.randint(1, 4)
    parts = []
    for _ in range(n_thin):
        sd = _thin_part(rng)
        # scale close to 1 so the feature thickness stays resolvable
        xf, s = _random_rigid(rng, 0.85, 1.0)
        parts.append((sd, xf, s))
    if rng.rand() < 0.5:  # attach a compact blob (plate-on-body CAD look)
        sd = _random_primitive(rng)
        xf, s = _random_rigid(rng, 0.4, 0.65)
        parts.append((sd, xf, s))

    def sdf(p):
        d = None
        for sd, xf, s in parts:
            di = sd(xf(p)) * s
            # hard union only — smoothing would fatten the thin features
            d = di if d is None else np.maximum(d, di)
        return d

    return sdf


# ------------------------------------------------------- icosphere ------

_ICO_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_V = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float64)
_ICO_F = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int64)


def icosphere(subdivisions: int = 3):
    """Unit icosphere by midpoint subdivision (watertight by construction)."""
    v = _ICO_V / np.linalg.norm(_ICO_V, axis=1, keepdims=True)
    f = _ICO_F.copy()
    for _ in range(subdivisions):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_idx = len(v) + np.arange(len(uniq))
        v = np.concatenate([v, mid])
        e01 = mid_idx[inv[: len(f)]]
        e12 = mid_idx[inv[len(f): 2 * len(f)]]
        e20 = mid_idx[inv[2 * len(f):]]
        f = np.concatenate([
            np.stack([f[:, 0], e01, e20], 1),
            np.stack([f[:, 1], e12, e01], 1),
            np.stack([f[:, 2], e20, e12], 1),
            np.stack([e01, e12, e20], 1),
        ])
    return v, f


def _bumpy_mesh(rng):
    v, f = icosphere(subdivisions=3 + rng.randint(0, 2))
    n_waves = rng.randint(2, 6)
    r = np.full(len(v), 1.0)
    for _ in range(n_waves):
        k = rng.uniform(1.0, 4.0, 3)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.03, 0.18) / n_waves * 3
        r += amp * np.cos(v @ k * np.pi + phase)
    r = np.clip(r, 0.4, 1.8)
    scale = rng.uniform(0.6, 1.0, 3)  # anisotropic squash
    return v * r[:, None] * scale, f


def _hull_mesh(rng):
    """Convex hull of a random point set (scipy Qhull — CPU datagen tool,
    same dependency tier as the reference's scipy usage)."""
    from scipy.spatial import ConvexHull

    pts = rng.randn(rng.randint(6, 40), 3) * rng.uniform(0.3, 0.6, 3)
    hull = ConvexHull(pts)
    v = pts[hull.vertices]
    remap = {old: i for i, old in enumerate(hull.vertices)}
    f = np.vectorize(remap.get)(hull.simplices)
    # Qhull simplices are not consistently oriented; Mesh.fixed_inversion
    # handles global flips, so first orient each face outward from the
    # centroid (valid for convex bodies).
    c = v.mean(0)
    fv = v[f]
    normals = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    outward = np.einsum("ij,ij->i", normals, fv.mean(1) - c) > 0
    f[~outward] = f[~outward][:, ::-1]
    return v, f


# ------------------------------------------------------------ driver ----


_GRID_CACHE: dict = {}


def _mesh_from_sdf(sdf, res=72):
    # grid construction is ~2s at res 160 and identical across attempts;
    # cache it, and evaluate the SDF in float32 chunks — the zoo's
    # primitives are numerically trivial (O(1) coordinates, features
    # >= 0.02 thick), and whole-volume float64 evaluation allocates
    # dozens of 100 MB temporaries per retry attempt (measured: the
    # generator spent 75% of its time in the allocator at res 160)
    grid = _GRID_CACHE.get(res)
    if grid is None:
        lin = np.linspace(-1.0, 1.0, res, dtype=np.float32)
        x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
        grid = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        _GRID_CACHE[res] = grid
    vol = np.empty(grid.shape[0], np.float32)
    step = 1 << 19
    for s in range(0, grid.shape[0], step):
        vol[s : s + step] = sdf(grid[s : s + step])
    vol = vol.reshape(res, res, res)
    # force the boundary outside so the isosurface closes inside the grid
    vol[[0, -1], :, :] = -1.0
    vol[:, [0, -1], :] = -1.0
    vol[:, :, [0, -1]] = -1.0
    # the C++ build (~8x over the numpy path): the thin style marches at
    # res 160 (4.1M voxels)
    v, f = extract_isosurface(vol, 0.0)
    if len(v) == 0:
        return None
    v = v / (res - 1) * 2.0 - 1.0
    return v.astype(np.float32), f


def generate_mesh(seed: int, style: str | None = None):
    """One watertight mesh; retries internally on degenerate draws."""
    for attempt in range(8):
        rng = np.random.RandomState(seed * 131 + attempt)
        st = style or ("csg", "csg", "bumpy", "hull")[rng.randint(0, 4)]
        if st == "csg":
            out = _mesh_from_sdf(_csg_sdf(rng))
            if out is None:
                continue
            v, f = out
        elif st == "thin":
            # higher marching resolution: a 0.03-thick plate needs >= 2
            # voxels across (2/159 = 0.0126 per voxel at res 160)
            out = _mesh_from_sdf(_thin_sdf(rng), res=160)
            if out is None:
                continue
            v, f = out
        elif st == "bumpy":
            v, f = _bumpy_mesh(rng)
        elif st == "hull":
            v, f = _hull_mesh(rng)
        else:
            raise ValueError(st)
        mesh = Mesh(np.asarray(v, np.float32), np.asarray(f)).cleaned()
        # thin style: a genuine plate/rod/ring marched at res 160 yields
        # thousands of faces; a low count means marching collapsed the
        # draw to a degenerate blob/box (observed: a 24-face box accepted
        # as "thin" in proc_240_thin), which dilutes the family
        min_faces = 2000 if st == "thin" else 16
        if len(mesh.faces) < min_faces or not mesh.is_watertight():
            continue
        mesh = mesh.fixed_inversion()
        if mesh.volume <= 1e-6:
            continue
        return mesh
    raise RuntimeError(f"no watertight mesh after 8 attempts (seed {seed})")


def make_procedural_meshes(out_dir: str, n: int, seed: int = 0,
                           styles=None) -> list[str]:
    """Write ``n`` watertight meshes to ``out_dir/00_base_meshes`` ready for
    :func:`datagen.make_dataset.make_dataset`. Returns the mesh names."""
    mesh_dir = os.path.join(out_dir, "00_base_meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    names = []
    for i in range(n):
        style = styles[i % len(styles)] if styles else None
        name = f"proc_{seed + i:05d}"
        out_file = os.path.join(mesh_dir, name + ".ply")
        # meshes are deterministic in (seed+i, style): an existing file is
        # identical to what we would regenerate, so large runs resume
        if not os.path.isfile(out_file):
            mesh = generate_mesh(seed + i, style)
            mesh_io.write_ply(out_file, mesh.vertices, mesh.faces)
        names.append(name)
    return names
