"""Volumetric SDF ops (counterpart of ``points2surf_tpu/ops/voxel.py``).

The reconstruction query set (voxelize the cloud, grow it by a box filter,
list the near-surface voxel centers in Morton order) and the volume that
marching reads (splat the query distances, drop isolated wrong-sign seeds,
propagate signs). Every box filter is three banded fp32 matmuls, exact on
the integer sign and occupancy fields, so these ops give the same bits on
the card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.utils import trace


def model_space_to_volume_space(pts_ms: torch.Tensor,
                                vol_res: int) -> torch.Tensor:
    """floor((p + 1) / 2 * res) (reference sdf.py:73-75), clipped."""
    ids = torch.floor((pts_ms + 1.0) / 2.0 * vol_res).to(torch.int64)
    return torch.clamp(ids, 0, vol_res - 1)


def volume_space_to_model_space(pts_vs, vol_res: int):
    """((v + 0.5) / res) * 2 - 1 (reference sdf.py:78-79): voxel ids to
    their centres in model space."""
    return ((pts_vs + 0.5) / vol_res) * 2.0 - 1.0


def make_grid_points(grid_resolution: int) -> np.ndarray:
    """All voxel centres of the unit-cube grid, (res^3, 3) float32: the
    point set of reference sdf.py:9-17, in the JAX package's order (x
    slowest)."""
    vs = 1.0 / grid_resolution
    lin = np.linspace(-1.0, 1.0 - vs, grid_resolution,
                      dtype=np.float32) + vs
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    return pts - vs * 0.5


def voxelize(pts_ms: torch.Tensor, n_valid, vol_res: int) -> torch.Tensor:
    """Binary occupancy volume (res, res, res) of a padded cloud; rows >=
    n_valid are ignored (sdf.py:56-59)."""
    ids = model_space_to_volume_space(pts_ms, vol_res)
    flat = (ids[:, 0] * vol_res + ids[:, 1]) * vol_res + ids[:, 2]
    valid = torch.arange(pts_ms.shape[0], device=pts_ms.device) < n_valid
    vol = torch.zeros(vol_res ** 3, dtype=torch.int32, device=pts_ms.device)
    vol.index_put_((flat,), valid.to(torch.int32), accumulate=True)
    return (vol > 0).reshape(vol_res, vol_res, vol_res)


def _band_matrix(n: int, size: int, device) -> torch.Tensor:
    """(n, n) matrix B with B[i, j] = multiplicity of row j in the
    edge-replicated length-``size`` window centered at i."""
    offs = torch.arange(size, device=device) - (size - 1) // 2
    src = torch.clamp(torch.arange(n, device=device)[:, None] + offs, 0, n - 1)
    rows = torch.arange(n, device=device)[:, None].expand_as(src)
    band = torch.zeros((n, n), dtype=torch.float32, device=device)
    return band.index_put_((rows, src), torch.ones_like(src, dtype=band.dtype),
                           accumulate=True)


def _box_sum_int(vol: torch.Tensor, size: int) -> torch.Tensor:
    """(size^3) box-filter sum with edge replication (scipy
    ``convolve(ones((s, s, s)), mode='nearest')``, sdf.py:62-63) as three
    banded fp32 matmuls; exact for integer volumes, whose partial sums stay
    far below 2^24."""
    x = vol.to(torch.float32)
    b0, b1, b2 = (_band_matrix(s, size, vol.device) for s in vol.shape)
    x = torch.einsum("ij,jkl->ikl", b0, x)
    x = torch.einsum("ij,kjl->kil", b1, x)
    return torch.einsum("ij,klj->kli", b2, x)


def near_surface_mask(pts_ms: torch.Tensor, n_valid, vol_res: int,
                      threshold_vs: int) -> torch.Tensor:
    """Boolean volume of voxels within a box neighborhood of the cloud
    (reference sdf.py:46-70), with the reference's quirk of dropping the
    last plane in each dimension (sdf.py:66)."""
    grown = _box_sum_int(voxelize(pts_ms, n_valid, vol_res), threshold_vs) > 0
    grown[-1, :, :] = False
    grown[:, -1, :] = False
    grown[:, :, -1] = False
    return grown


def _morton_order_host(vs: np.ndarray) -> np.ndarray:
    """Stable order of integer voxel coordinates (Q, 3) by Morton code, so
    batches cut from the list are tight spatial blocks."""
    g = torch.from_numpy(vs.astype(np.int64))

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(g[:, 0]) | (spread(g[:, 1]) << 1) | (spread(g[:, 2]) << 2)
    return torch.argsort(code, stable=True).numpy()


def grid_query_points(pts_ms: np.ndarray, vol_res: int, threshold_vs: int,
                      device: torch.device | str = "cuda") -> np.ndarray:
    """Near-surface voxel centers in model space, (Q, 3) float32 on the
    host, Morton-ordered. The mask is computed on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = require_cuda(device)
    with trace.blocking(dev):
        pts = torch.as_tensor(np.asarray(pts_ms)[:, :3], dtype=torch.float32,
                              device=dev)
    mask = near_surface_mask(pts, pts.shape[0], vol_res, threshold_vs)
    with trace.blocking(dev):
        mask = mask.cpu().numpy()
    vs = np.stack(np.nonzero(mask), axis=1)
    vs = vs[_morton_order_host(vs)].astype(np.float32)
    return (((vs + 0.5) / vol_res) * 2.0 - 1.0).astype(np.float32)


def splat_to_volume(pos_ms: torch.Tensor, val: torch.Tensor, n_valid,
                    vol_res: int) -> torch.Tensor:
    """Scatter SDF samples into a zero-initialized (res, res, res) float32
    volume (sdf.py:82-111).

    Grid-generated query points hit each voxel at most once, so the sum is a
    plain scatter (the reference's closest-to-center tie-break degenerates
    to first-wins, sdf.py:93-94). Rows >= n_valid write 0, a no-op value.
    """
    ids = model_space_to_volume_space(pos_ms, vol_res)
    flat = (ids[:, 0] * vol_res + ids[:, 1]) * vol_res + ids[:, 2]
    valid = torch.arange(pos_ms.shape[0], device=pos_ms.device) < n_valid
    v = torch.where(valid, val.to(torch.float32), 0.0)
    vol = torch.zeros(vol_res ** 3, dtype=torch.float32, device=pos_ms.device)
    vol.index_put_((flat,), v, accumulate=True)
    return vol.reshape(vol_res, vol_res, vol_res)


def filter_seed_signs(vol: torch.Tensor, size: int = 3,
                      threshold: int = 4) -> torch.Tensor:
    """Zero out seed voxels whose sign disagrees with the local seed majority.

    Flood-containment pre-pass for :func:`propagate_sign`: a handful of
    wrong-sign predictions in the near-surface band can open "channels"
    through which sign propagation floods the whole volume. A seed whose
    sign is opposed by at least ``threshold`` net neighboring seeds (in a
    ``size``^3 box, excluding itself) is reset to unknown (0), so
    propagation fills it from its surroundings. Voxels at the true surface
    see both signs in balance and are untouched for any threshold >= 2.
    """
    sign0 = torch.sign(vol)
    others = _box_sum_int(sign0, size) - sign0
    bad = (sign0 * others) <= -float(threshold)
    return torch.where(bad, 0.0, vol)


def propagate_sign(vol: torch.Tensor, sigma: int = 5,
                   certainty_threshold: int = 13) -> torch.Tensor:
    """Iteratively propagate SDF signs from seed voxels (sdf.py:114-178).

    Each round sums the current {-1,0,+1} sign field over a (sigma^3) box;
    voxels unknown at the start whose neighborhood sum clears the certainty
    threshold adopt the majority sign. A round merges only while it leaves
    fewer unknowns (zeros over the whole volume) than the field had before
    it; the first round that does not ends the loop. Each round's test costs
    one host sync. The volume borders are assumed outside (forced to -1) in
    the *output* only, not in the seeds (the reference's in-place border
    write, sdf.py:149-154). The rounds count in ``volume.rounds``.
    """
    sign = torch.sign(vol)
    unknown_init = sign == 0.0
    rounds = 0
    while True:
        rounds += 1
        unknown_before = torch.count_nonzero(sign == 0.0)
        conv = _box_sum_int(sign, sigma)
        new = torch.sign(torch.where(conv.abs() < certainty_threshold, 0.0,
                                     conv))
        unknown_after = torch.count_nonzero(new == 0.0)
        with trace.blocking(vol.device):
            more = bool((unknown_before > 0)
                        & (unknown_after < unknown_before))
        if not more:
            break
        sign = torch.where(unknown_init, new, sign)
    trace.count("volume.rounds", rounds)

    vol_b = vol.clone()
    for axis in range(3):
        vol_b.select(axis, 0).fill_(-1.0)
        vol_b.select(axis, -1).fill_(-1.0)
    return torch.where(vol_b == 0.0, sign, vol_b)
