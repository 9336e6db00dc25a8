"""Reconstruction query set (counterpart of the query-set half of
``points2surf_tpu/ops/voxel.py``): voxelize the cloud, grow it by a box
filter, and list the near-surface voxel centers in Morton order.

Splatting and sign propagation come with the volume slice.
"""

from __future__ import annotations

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda


def model_space_to_volume_space(pts_ms: torch.Tensor,
                                vol_res: int) -> torch.Tensor:
    """floor((p + 1) / 2 * res) (reference sdf.py:73-75), clipped."""
    ids = torch.floor((pts_ms + 1.0) / 2.0 * vol_res).to(torch.int64)
    return torch.clamp(ids, 0, vol_res - 1)


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
    pts = torch.as_tensor(np.asarray(pts_ms)[:, :3], dtype=torch.float32,
                          device=require_cuda(device))
    mask = near_surface_mask(pts, pts.shape[0], vol_res, threshold_vs)
    vs = np.stack(np.nonzero(mask.cpu().numpy()), axis=1)
    vs = vs[_morton_order_host(vs)].astype(np.float32)
    return (((vs + 0.5) / vol_res) * 2.0 - 1.0).astype(np.float32)
