"""Plain PyTorch reference of the reconstruction grid and of the volume that
marching reads (upstream ``source/sdf.py``: ``get_voxel_centers_grid_
smaller_pc``, ``add_samples_to_volume``, ``propagate_sign``).

Box sums are integer prefix sums over an edge-replicated volume, so both
functions are exact and independent of the program's banded matmuls.
"""

from __future__ import annotations

import torch


def box_sum(vol: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over the ``size``^3 box around each voxel, edges replicated
    (scipy ``convolve(..., mode='nearest')``), in int64."""
    x = vol.to(torch.int64)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    for axis in range(3):
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(-lo, n + hi, device=x.device), 0,
                          n - 1)
        x = torch.index_select(x, axis, idx)
        c = torch.cumsum(x, dim=axis)
        zero = torch.zeros_like(c.narrow(axis, 0, 1))
        c = torch.cat([zero, c], dim=axis)
        x = c.narrow(axis, size, n) - c.narrow(axis, 0, n)
    return x


def _voxel_ids(pts: torch.Tensor, res: int) -> torch.Tensor:
    ids = torch.floor((pts + 1.0) / 2.0 * res).to(torch.int64)
    return torch.clamp(ids, 0, res - 1)


def _morton(v: torch.Tensor) -> torch.Tensor:
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return spread(v[:, 0]) | (spread(v[:, 1]) << 1) | (spread(v[:, 2]) << 2)


def grid_queries(pts: torch.Tensor, res: int, eps: int) -> torch.Tensor:
    """Centres (Q, 3) of the voxels within the ``eps`` box of an occupied
    voxel, the last plane of each axis left out (upstream's quirk), in
    Morton order of their voxel coordinates."""
    ids = _voxel_ids(pts, res)
    occ = torch.zeros((res, res, res), dtype=torch.int64, device=pts.device)
    occ[ids[:, 0], ids[:, 1], ids[:, 2]] = 1
    near = box_sum(occ, eps) > 0
    near[-1], near[:, -1], near[:, :, -1] = False, False, False
    vs = torch.nonzero(near)
    vs = vs[torch.argsort(_morton(vs), stable=True)]
    return ((vs.to(torch.float32) + 0.5) / res) * 2.0 - 1.0


def volume(query_pts: torch.Tensor, dist: torch.Tensor, res: int,
           sigma: int, certainty: int) -> torch.Tensor:
    """(res,)*3 float32 volume in [-1, 1]: the distances at their voxels,
    the signs of unknown voxels propagated by box majority (``sigma``^3,
    at least ``certainty`` net votes) round by round while a round leaves
    fewer unknown voxels, the borders outside."""
    ids = _voxel_ids(query_pts, res)
    vol = torch.zeros((res, res, res), dtype=torch.float32,
                      device=query_pts.device)
    vol.index_put_((ids[:, 0], ids[:, 1], ids[:, 2]), dist.float(),
                   accumulate=True)
    sign = torch.sign(vol).to(torch.int64)
    unknown = sign == 0
    while True:
        before = int(torch.count_nonzero(sign == 0))
        votes = box_sum(sign, sigma)
        new = torch.where(votes.abs() < certainty, 0, torch.sign(votes))
        after = int(torch.count_nonzero(new == 0))
        if not (before > 0 and after < before):
            break
        sign = torch.where(unknown, new, sign)
    out = vol.clone()
    for axis in range(3):
        out.select(axis, 0).fill_(-1.0)
        out.select(axis, -1).fill_(-1.0)
    out = torch.where(out == 0.0, sign.to(torch.float32), out)
    return torch.clamp(out, -1.0, 1.0)
