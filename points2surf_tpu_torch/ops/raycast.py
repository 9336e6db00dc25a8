"""On-device ray-mesh intersection (Möller–Trumbore, brute force)
(counterpart of ``points2surf_tpu/ops/raycast.py``).

Powers the virtual scanner (``datagen/scanner.py``) that replaces the
reference's external BlenSor/Blender dependency (make_dataset.py:242-380):
one scan is a grid of rays against all triangles, streamed over triangle
chunks, nearest hit wins. The JAX package computes this with XLA-fused
``jnp``; here it is the same elementwise fp32 arithmetic as eager PyTorch
ops on the tensors' device, with no matmul (so TF32 cannot enter).

Eager PyTorch materialises what XLA fuses: each (rows, chunk) temporary
is a real tensor. :func:`row_blocks` splits the rows of a call so that
rows x ``tri_chunk`` stays at most :data:`PAIRS_PER_BLOCK`, which bounds the
working set of one block whatever the call's size; rows are independent,
so the split does not change any result.

Vectors are tuples of three planes (:func:`planes`), and every product,
sum and difference of a dot or cross product is its own eager op
(:func:`dot3`, :func:`cross3`), rounded once in a fixed order: no compiler
can contract a product and a sum into an FMA, so the card and the CPU
compute the same bits. XLA's CPU compiler does contract them in the JAX
package: ``jnp.cross`` is ``fma(x1, y2, -(x2 y1))`` per component and a
three-term ``jnp.sum`` of products ``fma(x2, y2, fma(x1, y1, x0 y0))``.
A ray's ``t`` is ill-conditioned where the ray grazes its triangle (a
small determinant), so the ray caster forms those FMAs itself
(:func:`fma`, in float64, where a float32 product is exact): it then
gives JAX's hits and ``t`` bit for bit, on the card as on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda

#: ray-triangle (or point-triangle) pairs of one block: one (rows, chunk)
#: fp32 temporary of a block is 67 MB
PAIRS_PER_BLOCK = 1 << 24


def planes(x: torch.Tensor):
    """(..., 3) -> the three (...) component planes (views)."""
    return x[..., 0], x[..., 1], x[..., 2]


def sub3(x, y):
    return x[0] - y[0], x[1] - y[1], x[2] - y[2]


def dot3(x, y):
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def cross3(x, y):
    return (x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
            x[0] * y[1] - x[1] * y[0])


def fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    rounds it (the float64 product of two float32 values is exact)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def cross3_fma(x, y):
    return (fma(x[1], y[2], -(x[2] * y[1])), fma(x[2], y[0], -(x[0] * y[2])),
            fma(x[0], y[1], -(x[1] * y[0])))


def dot3_fma(x, y):
    return fma(x[2], y[2], fma(x[1], y[1], x[0] * y[0]))


def row_blocks(n_rows: int, tri_chunk: int):
    """(start, stop) of the row blocks of a call against ``tri_chunk``
    triangles at a time."""
    step = max(1, PAIRS_PER_BLOCK // tri_chunk)
    return [(r0, min(r0 + step, n_rows)) for r0 in range(0, n_rows, step)]


def triangle_chunks(tri_a, tri_b, tri_c, n_tris: int, tri_chunk: int):
    """Yield (start, a, b, c, valid) per chunk of a padded triangle soup:
    the vertices as planes of shape (1, C) and the (1, C) mask of rows
    below ``n_tris``."""
    for s0 in range(0, tri_a.shape[0], tri_chunk):
        a, b, c = (planes(t[s0:s0 + tri_chunk][None])
                   for t in (tri_a, tri_b, tri_c))
        col = s0 + torch.arange(a[0].shape[1], device=tri_a.device)
        yield s0, a, b, c, (col < n_tris)[None]


def raycast_padded(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    tri_a: torch.Tensor,
    tri_b: torch.Tensor,
    tri_c: torch.Tensor,
    n_tris: int,
    tri_chunk: int = 2048,
):
    """Nearest-hit raycast against a padded triangle soup.

    Args:
      origins: (R, 3) ray origins.
      dirs: (R, 3) ray directions (need not be normalized; t is in units
        of |dir|).
      tri_a/b/c: (Fp, 3) triangle vertices, padding rows degenerate.
      n_tris: valid triangle count.

    Returns:
      t: (R,) hit parameter (inf where no hit).
      tri_id: (R,) int32 index of the hit triangle (-1 where no hit). Within
      a chunk the first index of the least t wins; across chunks only a
      strictly smaller t replaces the best, so the winner is the first
      triangle in index order.
    """
    eps = 1e-9
    r = origins.shape[0]
    best_t = torch.full((r,), float("inf"), dtype=torch.float32,
                        device=origins.device)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=origins.device)
    blocks = row_blocks(r, tri_chunk)
    for s0, a, b, c, valid in triangle_chunks(tri_a, tri_b, tri_c, n_tris,
                                              tri_chunk):
        e1 = sub3(b, a)  # planes (1, C)
        e2 = sub3(c, a)
        for r0, r1 in blocks:
            d = planes(dirs[r0:r1, None, :])  # planes (Rb, 1)
            o = planes(origins[r0:r1, None, :])
            h = cross3_fma(d, e2)  # planes (Rb, C)
            det = dot3_fma(e1, h)
            small = det.abs() < eps
            inv_det = torch.where(small, 0.0, 1.0 / det)
            s = sub3(o, a)
            u = dot3_fma(s, h) * inv_det
            del h
            q = cross3_fma(s, e1)
            del s
            v = dot3_fma(d, q) * inv_det
            t = dot3_fma(e2, q) * inv_det
            del q, inv_det
            hit = ((~small) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > 1e-6) & valid)
            del u, v
            t = torch.where(hit, t, float("inf"))
            tmin = t.amin(dim=1)
            amin = t.argmin(dim=1).to(torch.int32) + s0
            better = tmin < best_t[r0:r1]
            best_t[r0:r1] = torch.where(better, tmin, best_t[r0:r1])
            best_id[r0:r1] = torch.where(better, amin, best_id[r0:r1])
    best_id = torch.where(torch.isfinite(best_t), best_id, -1)
    return best_t, best_id


def pad_triangles(vertices: np.ndarray, faces: np.ndarray,
                  tri_chunk: int = 2048, device="cuda"):
    """Host helper: mesh -> padded (a, b, c) tensors on ``device`` + count.
    The padding rows are zero (degenerate) triangles up to a multiple of
    ``tri_chunk`` (at least one chunk)."""
    dev = require_cuda(device)
    f = np.asarray(faces, np.int64)
    v = np.asarray(vertices, np.float32)
    n_tris = len(f)
    fp = max(tri_chunk, -(-n_tris // tri_chunk) * tri_chunk)
    tri = np.zeros((3, fp, 3), np.float32)
    if n_tris:
        tri[:, :n_tris] = v[f.T]
    tri = torch.as_tensor(tri, device=dev)
    return tri[0], tri[1], tri[2], n_tris
