"""Brute-force distance helpers (counterpart of ``points2surf_tpu/ops/knn.py``).

Only what eval extraction uses is ported so far; the streaming
``patch_select`` waits for the slices that call it.
"""

from __future__ import annotations

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
