"""Figure generation: per-vertex error coloring of reconstructed meshes (a
copy of ``points2surf_tpu/evalx/figures.py``).

Role of the reference's source/figure/distance_vis.py + parula colormap
(source/base/parula_colormap.py). The colormap here is generated from parula
anchor colors by interpolation (not a copied table) — visually equivalent.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import spatial

from points2surf_tpu_torch.evalx.metrics import sample_mesh_surface
from points2surf_tpu_torch.utils import mesh_io

# parula-like anchors (blue -> cyan -> green -> yellow)
_ANCHORS = np.asarray(
    [
        (0.2081, 0.1663, 0.5292),
        (0.0601, 0.3599, 0.8683),
        (0.0783, 0.5041, 0.8384),
        (0.0231, 0.6418, 0.7914),
        (0.1024, 0.7098, 0.6729),
        (0.3006, 0.7444, 0.5415),
        (0.5946, 0.7318, 0.3695),
        (0.8186, 0.7328, 0.3499),
        (0.9763, 0.8286, 0.1899),
        (0.9764, 0.9831, 0.0538),
    ],
    np.float64,
)


def parula_colormap(n: int = 256) -> np.ndarray:
    """(n, 3) colormap in [0, 1]."""
    t = np.linspace(0.0, 1.0, n)
    anchor_t = np.linspace(0.0, 1.0, len(_ANCHORS))
    return np.stack(
        [np.interp(t, anchor_t, _ANCHORS[:, c]) for c in range(3)], axis=1
    )


def colorize(values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Map scalars to parula colors."""
    cmap = parula_colormap()
    vmin = float(values.min()) if vmin is None else vmin
    vmax = float(values.max()) if vmax is None else vmax
    t = (values - vmin) / max(vmax - vmin, 1e-12)
    idx = np.clip((t * 255).astype(int), 0, 255)
    return cmap[idx]


def visualize_mesh_with_distances(
    mesh_file: str, ref_mesh_file: str, out_file: str,
    samples_per_model: int = 10000, percentile: float = 95.0,
    vmax=None,
):
    """Color mesh vertices by distance to the reference surface
    (reference distance_vis.py:12-86). Returns the scale max used."""
    v, f = mesh_io.load_mesh(mesh_file)
    rv, rf = mesh_io.load_mesh(ref_mesh_file)
    ref_samples = sample_mesh_surface(rv, rf, samples_per_model)
    tree = spatial.cKDTree(ref_samples)
    dist, _ = tree.query(v, 1)
    if vmax is None:
        vmax = float(np.percentile(dist, percentile))
    colors = colorize(dist, 0.0, vmax)
    mesh_io.write_ply(out_file, v, f, colors=colors)
    return vmax


def make_distance_comparison(
    new_meshes_dir: str, ref_meshes_dir: str, out_dir: str,
    samples_per_model: int = 10000, percentile: float = 95.0,
):
    """Directory driver with a shared color scale across shapes
    (reference distance_vis.py make_distance_comparison)."""
    os.makedirs(out_dir, exist_ok=True)
    pairs = []
    for fn in sorted(os.listdir(new_meshes_dir)):
        stem = fn.split(".")[0]
        for rf in os.listdir(ref_meshes_dir):
            if rf.split(".")[0] == stem:
                pairs.append((fn, rf))
                break
    # first pass: collect scale
    scales = []
    for fn, rf in pairs:
        v, _ = mesh_io.load_mesh(os.path.join(new_meshes_dir, fn))
        rv, rff = mesh_io.load_mesh(os.path.join(ref_meshes_dir, rf))
        ref_samples = sample_mesh_surface(rv, rff, samples_per_model)
        tree = spatial.cKDTree(ref_samples)
        dist, _ = tree.query(v, 1)
        scales.append(np.percentile(dist, percentile))
    vmax = float(max(scales)) if scales else 1.0
    for fn, rf in pairs:
        visualize_mesh_with_distances(
            os.path.join(new_meshes_dir, fn),
            os.path.join(ref_meshes_dir, rf),
            os.path.join(out_dir, fn.split(".")[0] + ".ply"),
            samples_per_model, percentile, vmax=vmax,
        )
    return vmax
