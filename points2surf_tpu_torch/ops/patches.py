"""Patch extraction (counterpart of ``points2surf_tpu/ops/patches.py``).

For a batch of query points against a device-resident cloud: kNN patch
selection, pad-with-query, adaptive radius, patch-space normalization, the
distance-weighted global sub-sample and, in training, the rotation
augmentation.

Selection: coherent eval batches are Morton-sorted and cut into spatial
tiles; each tile takes the M cloud points nearest its centroid as shared
candidates, every query runs an exact top-k over them, and a per-tile
certificate (``d_k(q) + |q - centroid| <= R_M``) proves the result equals the
full-cloud kNN. If any tile fails, the whole batch is selected again against
the full cloud. Training batches (spread random patches) go straight to the
full-cloud selection. Selection is always exact ``torch.topk`` (the JAX
package selects training patches with ``approx_max_k``).

Randomness: the sub-sample's draws (the decimation offset and one
log-uniform per candidate) are made by :func:`draw_subsample` and passed in
as a :class:`SubsampleDraws`; a training batch adds one uniform rotation per
row (:class:`TrainDraws`, :func:`draw_batch`). A caller can so inject the
same numbers on two devices or frameworks.

Ball mode (``patch_radius > 0``) and the uniform with-replacement
sub-sample come with later slices and raise here.
"""

from __future__ import annotations

import dataclasses

import torch

from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops.knn import NEG_INF, _pairwise_sqdist


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Static patch-extraction parameters (the JAX package's ``PatchConfig``
    without ``recall_target``: selection here is always exact)."""

    points_per_patch: int = 300
    patch_radius: float = 0.0  # <= 0: kNN mode
    sub_sample_size: int = 1000
    uniform_subsample: bool = False
    fixed_subsample: bool = False
    exact: bool = False
    tile_queries: int = 128
    tile_candidates: int = 8192
    subsample_candidates: int = 8
    query_chunk: int = 512

    @property
    def knn_mode(self) -> bool:
        return self.patch_radius <= 0.0


@dataclasses.dataclass(frozen=True)
class SubsampleDraws:
    """Random numbers of one batch's global sub-sample."""

    offset: torch.Tensor  # () int64 decimation offset in [0, stride)
    logu: torch.Tensor  # (B, n_cand) float32 log-uniforms in (-inf, 0)


@dataclasses.dataclass(frozen=True)
class TrainDraws(SubsampleDraws):
    """Random numbers of one training batch: the sub-sample's, and one
    rotation per row for the augmentation (reference
    data_loader.py:381-393)."""

    rot: torch.Tensor  # (B, 3, 3) float32 rotations


def _morton_codes(q: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points in (-1, 1)^3 (10 bits/axis)."""
    g = torch.clamp(((q + 1.0) * 0.5 * 1024.0).to(torch.int32), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(g[:, 0]) | (spread(g[:, 1]) << 1) | (spread(g[:, 2]) << 2)


def subsample_candidates(n: int, cfg: PatchConfig,
                         small_cloud: bool) -> tuple[int, int]:
    """(stride, n_cand) of the sub-sample's candidate columns: every
    ``stride``-th cloud row from a random offset, or the whole cloud
    (stride 0)."""
    sub_n = cfg.sub_sample_size
    target = max(2 * sub_n, cfg.subsample_candidates * sub_n)
    if (not cfg.exact and not small_cloud and cfg.subsample_candidates > 0
            and n > 2 * target):
        stride = n // target
        return stride, n // stride
    return 0, n


def draw_subsample(generator: torch.Generator, b: int, n: int,
                   cfg: PatchConfig, small_cloud: bool = False
                   ) -> SubsampleDraws:
    """Draw a batch's sub-sample randomness on ``generator``'s device."""
    stride, n_cand = subsample_candidates(n, cfg, small_cloud)
    device = generator.device
    offset = torch.randint(0, max(stride, 1), (), generator=generator,
                           device=device)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((b, n_cand), generator=generator, device=device)
    return SubsampleDraws(offset, torch.log(u * (1.0 - tiny) + tiny))


def draw_batch(generator: torch.Generator, b: int, n: int, cfg: PatchConfig,
               small_cloud: bool = False, train: bool = False
               ) -> SubsampleDraws | TrainDraws:
    """A batch's draws as :func:`extract_patches` makes them from
    ``generator``: the sub-sample's (from a generator seeded 42 each time
    with ``cfg.fixed_subsample``) and, with ``train``, the rotations."""
    sub_gen = generator
    if cfg.fixed_subsample:
        sub_gen = torch.Generator(device=generator.device).manual_seed(42)
    sub = draw_subsample(sub_gen, b, n, cfg, small_cloud)
    if not train:
        return sub
    rot = geometry.random_rotation(generator, (b,), generator.device)
    return TrainDraws(sub.offset, sub.logu, rot)


def _tile_select(points, queries, n_valid, k, tile, m):
    """Morton-tiled kNN with a per-tile exactness certificate: tiles of
    ``tile`` queries, ``m`` shared candidates per tile.

    Returns ids (B, k) int64, the pad mask (B, k) (slots with no valid
    point), and a 0-d bool tensor: True iff every tile certified.
    """
    b = queries.shape[0]
    n = points.shape[0]
    order = torch.argsort(_morton_codes(queries), stable=True)
    qt = queries[order].reshape(b // tile, tile, 3)
    c = torch.mean(qt, dim=1, keepdim=True)  # (T, 1, 3)
    dc = _pairwise_sqdist(c, points)[:, 0]  # (T, N)
    col_invalid = torch.arange(n, device=points.device) >= n_valid
    neg_dc_cand, cand = torch.topk(
        torch.where(col_invalid, NEG_INF, -dc), m, dim=1)
    d2 = _pairwise_sqdist(qt, points[cand])  # (T, tile, M)
    scores = torch.where((cand >= n_valid)[:, None, :], NEG_INF, -d2)
    v, i = torch.topk(scores, k, dim=2)
    ids = torch.gather(cand[:, None, :].expand(-1, tile, -1), 2, i)
    # certificate (sound: the candidate d_k over-estimates the true one)
    r_m = torch.sqrt(torch.clamp(-neg_dc_cand[:, -1], min=0.0))
    q_c = torch.linalg.vector_norm(qt - c, dim=2)
    d_k = torch.sqrt(torch.clamp(-v[..., -1], min=0.0))
    certified = torch.all(torch.where(
        torch.isfinite(v[..., -1]), d_k + q_c <= r_m[:, None], True))
    ids_out = torch.empty((b, k), dtype=ids.dtype, device=ids.device)
    v_out = torch.empty((b, k), dtype=v.dtype, device=v.device)
    ids_out[order] = ids.reshape(b, k)
    v_out[order] = v.reshape(b, k)
    return ids_out, ~torch.isfinite(v_out), certified


def _dense_select(points, queries, n_valid, k, cfg):
    """Exact kNN against the full cloud, ``cfg.query_chunk`` rows at a time."""
    n = points.shape[0]
    invalid = (torch.arange(n, device=points.device) >= n_valid)[None, :]
    ids, pads = [], []
    for s in range(0, queries.shape[0], cfg.query_chunk):
        d2 = _pairwise_sqdist(queries[s:s + cfg.query_chunk], points)
        v, i = torch.topk(torch.where(invalid, NEG_INF, -d2), k, dim=1)
        ids.append(i)
        pads.append(~torch.isfinite(v))
    return torch.cat(ids), torch.cat(pads)


def _gumbel_subsample(points, queries, n_valid, sub_n, draws, cfg,
                      small_cloud, uniform_shuffle):
    """Distance-weighted (or, for small clouds, plain-shuffle) sampling
    without replacement: top-k of Efraimidis-Spirakis keys log(u) / w over
    a uniformly decimated candidate set."""
    b = queries.shape[0]
    n = points.shape[0]
    stride, n_cand = subsample_candidates(n, cfg, small_cloud)
    if tuple(draws.logu.shape) != (b, n_cand):
        raise ValueError(f"draws.logu has shape {tuple(draws.logu.shape)}, "
                         f"expected {(b, n_cand)}")
    cols = None
    cand_pts = points
    col_ids = torch.arange(n_cand, device=points.device)
    if stride:
        cols = draws.offset + stride * col_ids
        cand_pts = points[cols]
        col_ids = cols
    invalid = (col_ids >= n_valid)[None, :]
    if uniform_shuffle:
        # any monotone map of iid uniforms is a plain shuffle
        scores = draws.logu
    else:
        d = torch.sqrt(_pairwise_sqdist(queries, cand_pts))
        dmax = torch.amax(torch.where(invalid, NEG_INF, d), dim=1,
                          keepdim=True)
        w = torch.clamp(1.0 - 1.5 * d / dmax, 0.05, 1.0)
        scores = draws.logu / w
    v, i = torch.topk(torch.where(invalid, NEG_INF, scores), sub_n, dim=1)
    ids = cols[i] if cols is not None else i
    return ids, ~torch.isfinite(v)


def extract_patches(points: torch.Tensor, queries: torch.Tensor, n_valid,
                    rng: torch.Generator | SubsampleDraws, *,
                    cfg: PatchConfig, train: bool = False,
                    small_cloud: bool = False, coherent: bool = True) -> dict:
    """Extract network-ready patches for a batch of query points.

    Args:
      points: (N, 3) float32 cloud in model space, padded; rows >= n_valid
        are ignored.
      queries: (B, 3) float32 query points on the same device.
      n_valid: valid-row count (int or 0-d integer tensor).
      rng: a ``torch.Generator`` on the points' device, or the batch's
        :class:`SubsampleDraws` (:class:`TrainDraws` when ``train``).
      cfg: :class:`PatchConfig` (kNN mode).
      train: full-cloud selection and a random rotation of each row's
        patch, sub-sample and query (the reference's augmentation).
      small_cloud: True when n_valid < sub_sample_size (shuffle + zero pad).
      coherent: False when the queries are spatially spread, which skips
        the tile attempt.

    Returns the reference's batch keys: patch_pts_ps (B, k, 3),
    patch_radius_ms (B,), pts_sub_sample_ms (B, S, 3),
    imp_surf_query_point_ms (B, 3), imp_surf_query_point_ps (B, 3),
    patch_pts_ids (B, k).
    """
    if not cfg.knn_mode:
        raise NotImplementedError("ball-mode extraction is not ported yet")
    b = queries.shape[0]
    n = points.shape[0]
    k = cfg.points_per_patch
    sub_n = cfg.sub_sample_size
    if sub_n > 0 and cfg.uniform_subsample and not small_cloud:
        raise NotImplementedError("uniform sub-sampling is not ported yet")
    gen = rng if isinstance(rng, torch.Generator) else None
    if train and gen is None and not isinstance(rng, TrainDraws):
        raise TypeError("train-mode extraction takes a Generator or "
                        "TrainDraws (with the rotations)")

    tile_m = min(cfg.tile_candidates, n)
    use_tiles = (not cfg.exact and not train and coherent and n > 2 * tile_m
                 and b >= 64)
    if use_tiles:
        tile = min(cfg.tile_queries, b)
        pad_rows = (-b) % tile
        q_sel = (torch.cat([queries, queries[:1].expand(pad_rows, 3)])
                 if pad_rows else queries)
        ids, pad, all_cert = _tile_select(points, q_sel, n_valid, k, tile,
                                          tile_m)
        ids, pad = ids[:b], pad[:b]
        # any uncertified tile: select the whole batch again against the
        # full cloud (one host sync per batch)
        if not bool(all_cert):
            ids, pad = _dense_select(points, queries, n_valid, k, cfg)
    else:
        ids, pad = _dense_select(points, queries, n_valid, k, cfg)

    # padding slots land on the query point -> the patch origin
    patch_pts_ms = torch.where(pad[..., None], queries[:, None, :],
                               points[ids])
    radius = torch.clamp(geometry.patch_radii(patch_pts_ms, queries),
                         min=1e-12)
    patch_pts_ps = geometry.model_space_to_patch_space(patch_pts_ms, queries,
                                                       radius)

    if sub_n > 0:
        draws = rng
        if gen is not None:
            sub_gen = gen
            if cfg.fixed_subsample:
                sub_gen = torch.Generator(device=points.device).manual_seed(42)
            draws = draw_subsample(sub_gen, b, n, cfg, small_cloud)
        sub_ids, sub_pad = _gumbel_subsample(
            points, queries, n_valid, sub_n, draws, cfg, small_cloud,
            uniform_shuffle=small_cloud)
        sub = torch.where(sub_pad[..., None], 0.0, points[sub_ids])
    else:
        sub = torch.zeros((b, 0, 3), dtype=torch.float32, device=points.device)

    query_ms = queries
    if train:
        rot = (rng.rot if gen is None
               else geometry.random_rotation(gen, (b,), points.device))
        sub = geometry.transform_points(sub, rot)
        patch_pts_ps = geometry.transform_points(patch_pts_ps, rot)
        query_ms = torch.einsum("bij,bj->bi", rot, queries)

    return {
        "patch_pts_ps": patch_pts_ps,
        "patch_radius_ms": radius,
        "pts_sub_sample_ms": sub,
        "imp_surf_query_point_ms": query_ms,
        # (q - q) / r == 0, and stays 0 under the rotation
        "imp_surf_query_point_ps": torch.zeros_like(queries),
        "patch_pts_ids": ids,
    }
