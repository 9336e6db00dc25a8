"""Plain PyTorch reference of ball-mode patches: the upstream's fixed-radius
patch query (``source/base/point_cloud.py:170-194`` of
github.com/ErlerPhilipp/points2surf), with the port's keyed priorities in
place of its ``np.random.choice`` of the in-ball subset (both a uniformly
random subset).

For each query ``q`` of a batch: every valid point ``p`` with ``|q - p|^2 <=
r^2`` is in its ball; the ``k`` of them with the highest priorities form the
patch, and where the ball holds fewer than ``k`` the free slots take the
query point itself (the patch origin). The patch radius is ``r`` for every
row, and the signed distance is ``tanh(p0)^2`` with the sign of ``p1``, not
scaled by ``r`` (upstream ``compute_loss`` divides by the radius only for
``patch_radius <= 0``). The sub-sample, the squared distances and the patch
space are ``reference/data.py``'s.

The priority of point ``i`` for batch row ``j`` under the batch's ``key`` is
written here again from the port's documentation (``ops/patches.
ball_priorities``): with ``fmix32`` murmur3's 32-bit finalizer on unsigned
32-bit words (``h ^= h >> 16; h *= 0x85EBCA6B; h ^= h >> 13; h *=
0xC2B2AE35; h ^= h >> 16``, products modulo 2**32),
``s = fmix32((key mod 2**32) ^ j)`` and the priority is ``(fmix32(s ^ i) >>
8) / 2**24``.
"""

from __future__ import annotations

import torch

from reference.data import TIE, candidates, signed_distance, sqdist

# float32 products as written, on any device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M32 = 0xFFFFFFFF
# float32's |q|^2 - 2 q.p + |p|^2 is within ~11 units in the last place of
# |q|^2 + |p|^2 of the exact value (three roundings in each square sum,
# three in the dot product, two in the sum); two such results (the
# program's and this one's) are within twice that, 1.3e-6 of |q|^2 + |p|^2.
# A point whose squared distance lies that close to r^2 is in or out of the
# ball by rounding.
BAND = 1.3e-6


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c`` modulo 2**32 for int64 ``h`` in [0, 2**32), in 16-bit
    halves of ``c`` so that no product passes 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + ((h * hi) & 0xFFFF) * 2 ** 16) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer of int64 values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def priorities(key: torch.Tensor, rows: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """Priorities in [0, 1) of points ``ids`` for batch rows ``rows``
    (broadcast together), float32."""
    s = fmix32((key & M32) ^ rows)
    return (fmix32(s ^ ids) >> 8).to(torch.float32) / 2 ** 24


def patches(points: torch.Tensor, n_valid: int, queries: torch.Tensor,
            rows_in_batch: torch.Tensor, key: torch.Tensor, draws: dict,
            patch: dict, depth: int, tf32: bool = False, rows: int = 256):
    """The network inputs of an eval batch in ball mode: (patch points in
    patch space (B, k, 3), patch radius (B,), sub-sample in model space (B,
    S, 3), query (B, 3), rows whose result rounding decides (B,) bool, pad
    slots per row (B,)), ``rows`` queries at a time. ``rows_in_batch`` (B,)
    is each query's row in the program's batch (the priorities' row), and
    ``draws`` the sub-sample's (``offset``, ``logu``, or ``ids``), row for
    row with ``queries``.

    A row is left to rounding (``TIE``) when among the top-k priorities of
    the points within ``r^2`` plus the rounding band (``BAND``) lies one
    whose squared distance is within the band of ``r^2``, when the k-th and
    (k+1)-th of those priorities are equal, or where ``reference/data.py``
    flags the sub-sample's last kept and first dropped keys."""
    k, sub_n = patch["points_per_patch"], patch["sub_sample_size"]
    r2 = patch["patch_radius"] ** 2
    n = points.shape[0]
    dev = points.device
    ids_all = torch.arange(n, device=dev)
    valid = ids_all < n_valid
    p2 = torch.sum(points * points, 1)
    stride, n_cand = candidates(n, sub_n, depth)
    cols = torch.arange(n_cand, device=dev)
    if stride and not patch["uniform_subsample"]:
        cols = draws["offset"] + stride * cols
    out = []
    for s in range(0, queries.shape[0], rows):
        q = queries[s:s + rows]
        d2 = sqdist(q, points, tf32)
        band = BAND * (torch.sum(q * q, 1)[:, None] + p2[None, :])
        pr = priorities(key, rows_in_batch[s:s + rows, None],
                        ids_all[None, :])
        inside = valid[None, :] & (d2 <= r2)
        v, ids = torch.topk(torch.where(inside, pr, -1.0), min(k, n), dim=1)
        pad = v < 0
        pts = torch.where(pad[..., None], q[:, None, :], points[ids])
        radius = torch.full((len(q),), patch["patch_radius"],
                            dtype=points.dtype, device=dev)
        pts_ps = (pts - q[:, None, :]) / radius[:, None, None]

        near = valid[None, :] & (d2 <= r2 + band)
        edge = near & ((d2 - r2).abs() <= band)
        nv, nat = torch.topk(torch.where(near, pr, -1.0), min(k + 1, n), 1)
        top_edge = torch.gather(edge, 1, nat[:, :k]) & (nv[:, :k] >= 0)
        tie = top_edge.any(1)
        if n > k:
            tie |= (nv[:, k] >= 0) & (nv[:, k - 1] == nv[:, k])

        if patch["uniform_subsample"]:
            sub = points[draws["ids"][s:s + rows]]
        else:
            d = torch.sqrt(sqdist(q, points[cols], tf32))
            col_ok = cols < n_valid
            dmax = torch.amax(torch.where(col_ok[None, :], d,
                                          float("-inf")), 1, keepdim=True)
            w = torch.clamp(1.0 - 1.5 * d / dmax, 0.05, 1.0)
            skey = torch.where(col_ok[None, :],
                               draws["logu"][s:s + rows] / w, float("-inf"))
            kv, at = torch.topk(skey, min(sub_n + 1, skey.shape[1]), dim=1)
            last, drop = kv[:, sub_n - 1], kv[:, -1]
            tie |= (last - drop).abs() <= TIE * last.abs()
            kv, at = kv[:, :sub_n], at[:, :sub_n]
            sub = torch.where(torch.isfinite(kv)[..., None],
                              points[cols[at]], 0.0)
        out.append((pts_ps, radius, sub, q, tie, pad.sum(1)))
    return tuple(torch.cat(t) for t in zip(*out))


def fixed_radius_distance(pred: torch.Tensor) -> torch.Tensor:
    """(B, 2) raw magnitude and sign predictions -> (B,) signed distances,
    tanh(p0)^2 with the sign of p1, not scaled by the radius."""
    return signed_distance(pred, torch.ones_like(pred[:, 0]))
