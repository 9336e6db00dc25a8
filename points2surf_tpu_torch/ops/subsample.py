"""Global point-cloud sub-sampling, streamed (counterpart of
``points2surf_tpu/ops/subsample.py``; reference ``get_point_cloud_sub_sample``,
source/base/utils.py:196-227).

The extraction's sub-sample (``ops/patches._gumbel_subsample``) draws over a
uniformly decimated candidate set; this is the exact form over the whole
cloud, the oracle the decimated one is held against. Three modes:

* ``dist_weighted`` (the reference's default): ``n`` points without
  replacement, with probability ``clip(1 - 1.5 d / d_max, 0.05, 1)`` in the
  distance d to the query (utils.py:200-208), as the Gumbel top-n
  ``top_n(log w + G)``. Two passes over ``chunk`` columns at a time (the
  valid points' largest distance, then a running top-n merge), so no (B, N)
  weight matrix is formed.
* ``uniform``: ids uniformly with replacement (utils.py:213-216).
* small clouds (``small_cloud``): every valid point once, shuffled, then
  zero rows (utils.py:221-226): the Gumbel pass with unit weights.
"""

from __future__ import annotations

from typing import Callable

import torch

from points2surf_tpu_torch.ops.knn import NEG_INF, _pairwise_sqdist


def subsample_batch(points: torch.Tensor, queries: torch.Tensor, n_valid,
                    n: int,
                    rng: torch.Generator | Callable[[int, tuple],
                                                    torch.Tensor], *,
                    mode: str = "dist_weighted", small_cloud: bool = False,
                    chunk: int = 8192) -> torch.Tensor:
    """Sub-sample ``n`` global points per query.

    Args:
      points: (N, 3) padded cloud (model space).
      queries: (B, 3) query points on the same device.
      n_valid: the count of valid rows of ``points`` (an int).
      n: the sub-sample size.
      rng: a ``torch.Generator`` on the points' device, or (a caller's
        injected numbers) ``rng(ci, (B, chunk))``: the uniforms in
        [tiny, 1) of column chunk ``ci``'s Gumbel keys. The uniform mode
        takes a Generator.
      mode: 'dist_weighted' or 'uniform'.
      small_cloud: True when n_valid < n: the shuffle and zero padding.
      chunk: columns per streamed pass step.

    Returns (B, n, 3) points (zero rows for padding on small clouds).
    """
    if mode not in ("dist_weighted", "uniform"):
        raise ValueError(f"unknown subsample mode: {mode}")
    b = queries.shape[0]
    npts = points.shape[0]
    num_chunks = -(-npts // chunk)
    pts = torch.cat([points, points.new_zeros((num_chunks * chunk - npts,
                                                3))])
    n_valid = int(n_valid)

    if mode == "uniform" and not small_cloud:
        if not isinstance(rng, torch.Generator):
            raise TypeError("the uniform mode draws its ids from a Generator")
        ids = torch.randint(0, max(n_valid, 1), (b, n), generator=rng,
                            device=rng.device)
        return pts[ids]

    if isinstance(rng, torch.Generator):
        gen = rng

        def uniforms(ci, shape):
            tiny = torch.finfo(torch.float32).tiny
            u = torch.rand(shape, generator=gen, device=gen.device)
            return u * (1.0 - tiny) + tiny
    else:
        uniforms = rng

    cols = torch.arange(chunk, device=points.device)
    use_dist = mode == "dist_weighted" and not small_cloud
    if use_dist:
        # pass 1: each query's largest squared distance to a valid point
        dmax2 = torch.full((b,), NEG_INF, device=points.device)
        for ci in range(num_chunks):
            start = ci * chunk
            d2 = _pairwise_sqdist(queries, pts[start:start + chunk])
            d2 = torch.where(start + cols >= n_valid, NEG_INF, d2)
            dmax2 = torch.maximum(dmax2, torch.amax(d2, dim=1))
        dmax = torch.sqrt(torch.clamp(dmax2, min=1e-30))

    # pass 2: a running Gumbel top-n
    scores = torch.full((b, n), NEG_INF, device=points.device)
    ids = torch.zeros((b, n), dtype=torch.int64, device=points.device)
    for ci in range(num_chunks):
        start = ci * chunk
        col = start + cols
        g = -torch.log(-torch.log(uniforms(ci, (b, chunk))))
        if use_dist:
            d = torch.sqrt(_pairwise_sqdist(queries, pts[start:start + chunk]))
            w = torch.clamp(1.0 - 1.5 * d / dmax[:, None], 0.05, 1.0)
            score = torch.log(w) + g
        else:
            score = g
        score = torch.where(col >= n_valid, NEG_INF, score)
        top, at = torch.topk(torch.cat([scores, score], dim=1), n, dim=1)
        ids = torch.gather(torch.cat([ids, col.expand(b, -1)], dim=1), 1, at)
        scores = top
    # zero rows where no valid point was left (small clouds)
    return torch.where(torch.isfinite(scores)[..., None], pts[ids], 0.0)
