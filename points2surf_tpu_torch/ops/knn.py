"""Brute-force neighbour search (counterpart of ``points2surf_tpu/ops/knn.py``).

:func:`_pairwise_sqdist` is the distance that patch extraction
(``ops/patches.py``) selects with. :func:`patch_select` is the JAX package's
streaming selection: the cloud goes through in fixed-size chunks and each
query keeps a running top-k, merged chunk by chunk. Two modes, as the
reference's patch queries (source/base/point_cloud.py:170-194):

* kNN (``use_ball=False``): the k nearest points, ascending by distance;
* ball (``use_ball=True``): a uniformly random subset of at most k points
  within ``radius`` (the reference's ``rng.choice`` down-select), as the
  top-k of uniform priorities over the in-ball points.

Slots without a valid point (a cloud smaller than k, or fewer than k points
in the ball) are flagged in the pad mask.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG_INF = float("-inf")


def _pairwise_sqdist(queries: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., B, 3) x (..., C, 3) -> (..., B, C) squared distances.

    Same ``|q|^2 - 2 q.p + |p|^2`` expansion as the JAX package (not
    ``torch.cdist``), in fp32 and clamped at 0, so that orderings and ties
    match it."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    p2 = torch.sum(pts * pts, dim=-1).unsqueeze(-2)
    cross = torch.matmul(queries, pts.transpose(-1, -2))
    return torch.clamp(q2 - 2.0 * cross + p2, min=0.0)


def patch_select(points: torch.Tensor, queries: torch.Tensor, n_valid,
                 k: int, *, radius: float = 0.0,
                 priorities: torch.Generator | Callable | None = None,
                 chunk: int = 8192, use_ball: bool = False):
    """Select up to ``k`` patch point indices for each query.

    Args:
      points: (N, 3) cloud; rows >= n_valid are padding.
      queries: (B, 3) query points on the same device.
      n_valid: number of valid rows of ``points``.
      k: points per patch.
      radius: the ball's radius (ball mode).
      priorities: ball mode's uniform priorities in [0, 1): a
        ``torch.Generator`` on the points' device, or a callable
        ``(chunk_index, (B, chunk)) -> tensor`` that serves injected ones
        (the JAX package draws ``uniform(fold_in(key, chunk_index))``).
      chunk: points per streamed chunk; the cloud is zero-padded to a
        multiple of it.
      use_ball: ball mode instead of kNN mode.

    Returns ids (B, k) int64 (arbitrary in padded slots), squared distances
    (B, k) (kNN mode: ascending; ball mode: those of the random subset; 0
    in padded slots) and the pad mask (B, k) bool.
    """
    if use_ball and priorities is None:
        raise ValueError("ball mode requires priorities (a generator or a "
                         "source of uniform blocks)")
    n, b = points.shape[0], queries.shape[0]
    num_chunks = -(-n // chunk)
    pts = torch.cat([points, points.new_zeros(num_chunks * chunk - n, 3)])
    dev = points.device
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.zeros((b, k), dtype=torch.int64, device=dev)
    d2s = torch.zeros((b, k), dtype=torch.float32, device=dev)
    r2 = float(radius) ** 2
    for ci in range(num_chunks):
        start = ci * chunk
        d2 = _pairwise_sqdist(queries, pts[start:start + chunk])
        col = start + torch.arange(chunk, device=dev).expand(b, chunk)
        invalid = col >= n_valid
        if use_ball:
            if isinstance(priorities, torch.Generator):
                u = torch.rand((b, chunk), generator=priorities, device=dev)
            else:
                u = priorities(ci, (b, chunk))
            new = torch.where(invalid | (d2 > r2), NEG_INF, u)
        else:
            new = torch.where(invalid, NEG_INF, -d2)
        scores, top = torch.topk(torch.cat([scores, new], dim=1), k, dim=1)
        ids = torch.gather(torch.cat([ids, col], dim=1), 1, top)
        d2s = torch.gather(torch.cat([d2s, d2], dim=1), 1, top)
    pad = ~torch.isfinite(scores)
    return ids, torch.where(pad, 0.0, d2s), pad


def knn(points, queries, n_valid, k: int, chunk: int = 8192):
    """k nearest neighbours: ids (B, k) ascending by distance, distances
    (B, k) and the pad mask."""
    ids, sqd, pad = patch_select(points, queries, n_valid, k, chunk=chunk)
    return ids, torch.sqrt(sqd), pad
