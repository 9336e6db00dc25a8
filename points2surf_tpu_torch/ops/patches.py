"""Patch extraction (counterpart of ``points2surf_tpu/ops/patches.py``).

For a batch of query points against a device-resident cloud: kNN patch
selection, pad-with-query, adaptive radius, patch-space normalization, the
distance-weighted global sub-sample and, in training, the rotation
augmentation.

Selection: coherent eval batches are Morton-sorted and cut into spatial
tiles; each tile takes the M cloud points nearest its centroid as shared
candidates and every query selects among them, with a per-tile certificate
that the result equals the full-cloud selection:

* kNN mode (``patch_radius <= 0``): an exact top-k by distance, certified by
  ``d_k(q) + |q - centroid| <= R_M``;
* ball mode (``patch_radius = r > 0``, the reference's uniformly random
  subset of the in-ball points, point_cloud.py:177-183): the top-k of
  uniform priorities over the in-ball candidates, certified by
  ``max_q |q - centroid| + r <= R_M`` (then every in-ball point is a
  candidate). M grows with the expected in-ball count
  (:func:`ball_tile_candidates`). The radius is ``r`` itself. Eval
  batches key each priority by (batch row, point id)
  (:func:`ball_priorities`), so a certified tile, the dense path and any
  device select the same set.

If any tile fails, the whole batch is selected again against the full cloud.
Training batches (spread random patches) go straight to the full-cloud
selection. Selection is always exact ``torch.topk`` (the JAX package selects
training patches with ``approx_max_k``, which is exact on the CPU).

Global sub-sample: distance-weighted without replacement over a uniformly
decimated candidate set (the Efraimidis-Spirakis keys ``log(u) / w``), or
with ``uniform_subsample`` ids drawn uniformly with replacement; a cloud with
fewer valid points than the sub-sample is shuffled and zero-padded.

Randomness: the sub-sample's draws (the decimation offset and one
log-uniform per candidate, or the uniform mode's ids) are made by
:func:`draw_subsample` and passed in as a :class:`SubsampleDraws`; a training
batch adds one uniform rotation per row (:class:`TrainDraws`,
:func:`draw_batch`). Ball mode's priorities are a :class:`BallDraws` on the
same object, made block by block while the selection runs (a (B, N) block at
batch 4096 on a 65,536-row cloud would be 1 GiB): in eval batches hashed
from one key per batch, in training drawn from the generator. A caller can
so inject the same numbers on two devices or frameworks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops.knn import NEG_INF, _pairwise_sqdist
from points2surf_tpu_torch.utils import trace


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


_M32 = 0xFFFFFFFF
# murmur3's finalizer multipliers less 2**32: h * (c - 2**32) has the low 32
# bits of h * c, and for h < 2**32 it stays inside int64
_FMIX_MUL = (0x85EBCA6B - 2 ** 32, 0xC2B2AE35 - 2 ** 32)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer of int64 values in [0, 2**32), in place."""
    h.bitwise_xor_(h >> 16)
    h.mul_(_FMIX_MUL[0]).bitwise_and_(_M32)
    h.bitwise_xor_(h >> 13)
    h.mul_(_FMIX_MUL[1]).bitwise_and_(_M32)
    return h.bitwise_xor_(h >> 16)


def ball_priorities(key: torch.Tensor, rows: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Eval-mode ball priorities in [0, 1): float32, of the broadcast shape
    of ``rows`` (batch rows) and ``ids`` (cloud point ids), both int64.

    With ``fmix32`` murmur3's 32-bit finalizer on unsigned 32-bit words
    (``h ^= h >> 16; h *= 0x85EBCA6B; h ^= h >> 13; h *= 0xC2B2AE35;
    h ^= h >> 16``, products modulo 2**32) and ``^`` exclusive or, the
    priority of point ``i`` for row ``j`` is::

        s = fmix32((key mod 2**32) ^ j)
        priority = (fmix32(s ^ i) >> 8) / 2**24

    Integer arithmetic only (int64 tensors, masked to 32 bits), so every
    device gives the same bits. Within a row the 32-bit hashes differ
    (``fmix32`` is a bijection); the 24-bit priorities may tie."""
    s = _fmix32((key & _M32) ^ rows)
    return (_fmix32(s ^ ids) >> 8).to(torch.float32) * 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class BallDraws:
    """Uniform priorities in [0, 1) of ball-mode selection, made when the
    selection asks for them, in one of two forms.

    Keyed (``key``, a 0-d int64 tensor on the points' device; eval
    batches): :func:`ball_priorities` of (the row's index in the batch, the
    point's id), so the tiles and the dense path select alike. Block (``source``; training and injected numbers):
    ``source(kind, index, shape)`` returns the (T, tile, M) blocks of the
    Morton-ordered tiles (``kind`` "tiles", index 0) or the (rows, N) block
    of the dense chunk that starts at query row ``index`` (``kind``
    "rows"). A generator's source draws in call order; a test's source
    serves injected numbers."""

    source: Callable[[str, int, tuple], torch.Tensor] | None = None
    key: torch.Tensor | None = None

    @staticmethod
    def from_generator(generator: torch.Generator) -> "BallDraws":
        def source(kind, index, shape):
            return torch.rand(shape, generator=generator,
                              device=generator.device)
        return BallDraws(source)

    @staticmethod
    def keyed(key: torch.Tensor) -> "BallDraws":
        return BallDraws(key=key)

    def block(self, kind: str, index: int, shape: tuple) -> torch.Tensor:
        u = self.source(kind, index, tuple(shape))
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"ball priorities of shape {tuple(u.shape)}, "
                             f"expected {tuple(shape)}")
        return u

    def _hashed(self, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        trace.count("extract.priorities",
                    math.prod(torch.broadcast_shapes(rows.shape, ids.shape)))
        with trace.span("extract.priorities"):
            return ball_priorities(self.key, rows, ids)

    def tiles(self, order: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """The (T, tile, M) priorities of the tiles: ``order`` (T, tile)
        each tile slot's row in the batch, ``cand`` (T, M) each tile's
        candidate ids."""
        if self.key is None:
            return self.block("tiles", 0, (*order.shape, cand.shape[1]))
        return self._hashed(order[..., None], cand[:, None, :])

    def dense(self, first: int, rows: int, n: int, device) -> torch.Tensor:
        """The (rows, n) priorities of the dense chunk of batch rows
        ``first:first + rows`` over every point."""
        if self.key is None:
            return self.block("rows", first, (rows, n))
        return self._hashed(
            torch.arange(first, first + rows, device=device)[:, None],
            torch.arange(n, device=device)[None, :])

    def to(self, device) -> "BallDraws":
        if self.key is not None:
            return dataclasses.replace(self, key=self.key.to(device))
        src = self.source
        return BallDraws(lambda kind, index, shape: src(
            kind, index, shape).to(device))

    def rows(self, lo: int, hi: int, total: int, chunk: int) -> "BallDraws":
        """The priorities of rows ``lo:hi`` of a batch of ``total`` rows
        whose dense selection asks for ``chunk`` rows at a time (a rank's
        share of the global batch, which selects densely: training). The
        whole batch's blocks are asked of this source in the order a
        one-process selection asks for them, and the rows outside
        ``lo:hi`` are dropped, so a generator's source advances by the
        whole batch's draw, as on every other rank."""
        block = self.block
        pending = []  # (first global row, rows) kept from drawn blocks
        drawn = [0]  # global rows drawn so far

        def source(kind, index, shape):
            if kind != "rows":
                raise ValueError("a rank's share of ball priorities serves "
                                 "dense selection only")
            a, b = lo + index, lo + index + shape[0]
            end = total if b >= hi else b
            while drawn[0] < end:
                s = drawn[0]
                u = block("rows", s, (min(chunk, total - s), shape[1]))
                keep = u[max(lo, s) - s:max(min(hi, s + len(u)) - s, 0)]
                if len(keep):
                    pending.append((max(lo, s), keep))
                drawn[0] = s + len(u)
            parts = [u[max(a, s) - s:b - s] for s, u in pending
                     if s < b and s + len(u) > a]
            pending[:] = [(s, u) for s, u in pending if s + len(u) > b]
            return torch.cat(parts)

        return BallDraws(source)


@dataclasses.dataclass(frozen=True)
class SubsampleDraws:
    """Random numbers of one batch: the global sub-sample's (the decimation
    offset and log-uniforms, or with ``uniform_subsample`` the ids) and, in
    ball mode, the selection's priorities."""

    offset: torch.Tensor | None  # () int64 decimation offset in [0, stride)
    logu: torch.Tensor | None  # (B, n_cand) float32 log-uniforms < 0
    # (B, S) int64 ids in [0, max(n_valid, 1)): the uniform sub-sample
    ids: torch.Tensor | None = dataclasses.field(default=None, kw_only=True)
    ball: BallDraws | None = dataclasses.field(default=None, kw_only=True)

    def to(self, device, dtype: torch.dtype | None = None):
        """The same draws on ``device`` (floating ones cast to ``dtype``)."""
        def move(t):
            if t is None or isinstance(t, BallDraws):
                return None if t is None else t.to(device)
            if dtype is not None and t.is_floating_point():
                return t.to(device, dtype)
            return t.to(device)
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    def rows(self, lo: int, hi: int, *, chunk: int):
        """The draws of rows ``lo:hi`` of this batch (a rank's share of the
        global batch's draws): the per-row log-uniforms, ids and rotations
        sliced, the shared decimation offset kept, and the ball priorities
        as :meth:`BallDraws.rows` gives them for a dense selection of
        ``chunk`` rows at a time."""
        per_row = [getattr(self, f.name) for f in dataclasses.fields(self)
                   if f.name not in ("offset", "ball")]
        total = next(t.shape[0] for t in per_row if t is not None)

        def take(name, t):
            if t is None or name == "offset":
                return t
            if isinstance(t, BallDraws):
                return t.rows(lo, hi, total, chunk)
            return t[lo:hi]

        return dataclasses.replace(self, **{
            f.name: take(f.name, getattr(self, f.name))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class TrainDraws(SubsampleDraws):
    """Random numbers of one training batch: :class:`SubsampleDraws`, and
    one rotation per row for the augmentation (reference
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


def _ball_tile_candidates(cfg: PatchConfig, n: int) -> int:
    """Candidate depth M of ball-mode tiles for a cloud padded to ``n``
    rows (the JAX package's rule): the certificate needs every point within
    ``max|q - c| + r`` of a tile's centroid among its candidates, and on a
    surface-sampled cloud that count grows ~ n r^2 until the ball covers a
    large part of the object. M = n * min(0.28, 27.3 r^2), at least
    ``cfg.tile_candidates``, rounded up to 1024, at most n."""
    factor = 27.3
    cap = 0.28
    frac = min(cap, factor * cfg.patch_radius ** 2)
    m = max(cfg.tile_candidates, int(-(-(n * frac) // 1024)) * 1024)
    return min(m, n)


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


def _uniform_mode(cfg: PatchConfig, small_cloud: bool) -> bool:
    """The with-replacement sub-sample (reference utils.py:213-216); small
    clouds keep the shuffle and zero padding."""
    return cfg.uniform_subsample and not small_cloud


def draw_subsample(generator: torch.Generator, b: int, n: int,
                   cfg: PatchConfig, small_cloud: bool = False,
                   n_valid: int | None = None) -> SubsampleDraws:
    """Draw a batch's sub-sample randomness on ``generator``'s device. The
    uniform sub-sample draws its ids below ``max(n_valid, 1)``."""
    device = generator.device
    if _uniform_mode(cfg, small_cloud):
        if n_valid is None:
            raise ValueError("the uniform sub-sample needs n_valid")
        ids = torch.randint(0, max(int(n_valid), 1), (b, cfg.sub_sample_size),
                            generator=generator, device=device)
        return SubsampleDraws(None, None, ids=ids)
    stride, n_cand = subsample_candidates(n, cfg, small_cloud)
    offset = torch.randint(0, max(stride, 1), (), generator=generator,
                           device=device)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((b, n_cand), generator=generator, device=device)
    return SubsampleDraws(offset, torch.log(u * (1.0 - tiny) + tiny))


def draw_batch(generator: torch.Generator, b: int, n: int, cfg: PatchConfig,
               small_cloud: bool = False, train: bool = False,
               n_valid: int | None = None) -> SubsampleDraws | TrainDraws:
    """A batch's draws as :func:`extract_patches` makes them from
    ``generator``: the sub-sample's (from a generator seeded 42 each time
    with ``cfg.fixed_subsample``), with ``train`` the rotations, and in ball
    mode the selection's priorities: keyed by one key drawn from
    ``generator`` on its device, or with ``train`` made by ``generator``
    later, while the selection runs."""
    sub_gen = generator
    if cfg.fixed_subsample:
        sub_gen = torch.Generator(device=generator.device).manual_seed(42)
    sub = draw_subsample(sub_gen, b, n, cfg, small_cloud, n_valid)
    ball = None
    if not cfg.knn_mode and train:
        ball = BallDraws.from_generator(generator)
    elif not cfg.knn_mode:
        ball = BallDraws.keyed(torch.randint(
            0, 2 ** 32, (), generator=generator, device=generator.device))
    if not train:
        return dataclasses.replace(sub, ball=ball)
    rot = geometry.random_rotation(generator, (b,), generator.device)
    return TrainDraws(sub.offset, sub.logu, rot, ids=sub.ids, ball=ball)


def _tile_select(points, queries, n_valid, k, tile, m, radius=0.0,
                 ball: BallDraws | None = None):
    """Morton-tiled selection with a per-tile exactness certificate: tiles
    of ``tile`` queries, ``m`` shared candidates per tile. kNN mode without
    ``ball``; with it, the ball of ``radius``: the top-k of the uniform
    priorities over the in-ball candidates.

    Returns ids (B, k) int64, the pad mask (B, k) (slots with no valid
    point), and each tile's certificate (T,) bool.
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
    cand_invalid = (cand >= n_valid)[:, None, :]
    r_m = torch.sqrt(torch.clamp(-neg_dc_cand[:, -1], min=0.0))
    q_c = torch.linalg.vector_norm(qt - c, dim=2)
    if ball is None:
        v, i = torch.topk(torch.where(cand_invalid, NEG_INF, -d2), k, dim=2)
        # certificate (sound: the candidate d_k over-estimates the true one)
        d_k = torch.sqrt(torch.clamp(-v[..., -1], min=0.0))
        certified = torch.all(torch.where(
            torch.isfinite(v[..., -1]), d_k + q_c <= r_m[:, None], True),
            dim=1)
    else:
        with trace.blocking(points.device):  # a copy of a host scalar
            r = torch.tensor(radius, dtype=torch.float32,
                             device=points.device)
        u = ball.tiles(order.reshape(b // tile, tile), cand)
        v, i = torch.topk(torch.where(cand_invalid | (d2 > r * r), NEG_INF,
                                      u), k, dim=2)
        # every point within r of a query lies within max|q - c| + r of c
        certified = torch.amax(q_c, dim=1) + r <= r_m
    ids = torch.gather(cand[:, None, :].expand(-1, tile, -1), 2, i)
    ids_out = torch.empty((b, k), dtype=ids.dtype, device=ids.device)
    v_out = torch.empty((b, k), dtype=v.dtype, device=v.device)
    ids_out[order] = ids.reshape(b, k)
    v_out[order] = v.reshape(b, k)
    return ids_out, ~torch.isfinite(v_out), certified


def _dense_select(points, queries, n_valid, k, cfg,
                  ball: BallDraws | None = None):
    """Exact selection against the full cloud, ``cfg.query_chunk`` rows at
    a time: the kNN, or with ``ball`` the top-k of its uniform priorities
    over the points within ``cfg.patch_radius`` (one (rows, N) block per
    chunk)."""
    n = points.shape[0]
    invalid = (torch.arange(n, device=points.device) >= n_valid)[None, :]
    with trace.blocking(points.device):  # a copy of a host scalar
        r = torch.tensor(max(cfg.patch_radius, 0.0), dtype=torch.float32,
                         device=points.device)
    ids, pads = [], []
    for s in range(0, queries.shape[0], cfg.query_chunk):
        q = queries[s:s + cfg.query_chunk]
        d2 = _pairwise_sqdist(q, points)
        if ball is None:
            scores = torch.where(invalid, NEG_INF, -d2)
        else:
            u = ball.dense(s, q.shape[0], n, points.device)
            scores = torch.where(invalid | (d2 > r * r), NEG_INF, u)
        v, i = torch.topk(scores, k, dim=1)
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
    if draws.logu is None or tuple(draws.logu.shape) != (b, n_cand):
        shape = None if draws.logu is None else tuple(draws.logu.shape)
        raise ValueError(f"draws.logu has shape {shape}, expected "
                         f"{(b, n_cand)}")
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
        :class:`SubsampleDraws` (:class:`TrainDraws` when ``train``; with
        ``ball`` in ball mode), as :func:`draw_batch` makes them.
      cfg: :class:`PatchConfig` (kNN mode, or ball mode with
        ``patch_radius > 0``).
      train: full-cloud selection and a random rotation of each row's
        patch, sub-sample and query (the reference's augmentation).
      small_cloud: True when n_valid < sub_sample_size (shuffle + zero pad).
      coherent: False when the queries are spatially spread, which skips
        the tile attempt.

    Returns the reference's batch keys: patch_pts_ps (B, k, 3),
    patch_radius_ms (B,) (the fixed radius in ball mode),
    pts_sub_sample_ms (B, S, 3), imp_surf_query_point_ms (B, 3),
    imp_surf_query_point_ps (B, 3), patch_pts_ids (B, k).
    """
    b = queries.shape[0]
    n = points.shape[0]
    k = cfg.points_per_patch
    sub_n = cfg.sub_sample_size
    if isinstance(rng, torch.Generator):
        draws = draw_batch(rng, b, n, cfg, small_cloud, train,
                           n_valid=n_valid)
    else:
        draws = rng
    if train and not isinstance(draws, TrainDraws):
        raise TypeError("train-mode extraction takes a Generator or "
                        "TrainDraws (with the rotations)")
    ball = None
    if not cfg.knn_mode:
        ball = draws.ball
        if ball is None:
            raise TypeError("ball-mode extraction takes a Generator or "
                            "draws with the ball priorities")

    tile_m = (min(cfg.tile_candidates, n) if cfg.knn_mode
              else _ball_tile_candidates(cfg, n))
    use_tiles = (not cfg.exact and not train and coherent and n > 2 * tile_m
                 and b >= 64)
    dense = not use_tiles
    trace.count("extract.slots", b * k)
    if use_tiles:
        trace.count("extract.tiled")
        with trace.span("extract.tiles"):
            tile = min(cfg.tile_queries, b)
            pad_rows = (-b) % tile
            q_sel = (torch.cat([queries, queries[:1].expand(pad_rows, 3)])
                     if pad_rows else queries)
            ids, pad, cert = _tile_select(points, q_sel, n_valid, k, tile,
                                          tile_m, cfg.patch_radius, ball)
            ids, pad = ids[:b], pad[:b]
        # any uncertified tile: select the whole batch again against the
        # full cloud (one host sync per batch)
        with trace.span("extract.certify"), trace.blocking(cert.device):
            dense = not bool(torch.all(cert))
        if dense:
            trace.count("extract.fallback")
    if dense:
        trace.count("extract.dense_slots", b * k)
        with trace.span("extract.dense"):
            ids, pad = _dense_select(points, queries, n_valid, k, cfg, ball)

    # padding slots land on the query point -> the patch origin
    patch_pts_ms = torch.where(pad[..., None], queries[:, None, :],
                               points[ids])
    if cfg.knn_mode:
        radius = torch.clamp(geometry.patch_radii(patch_pts_ms, queries),
                             min=1e-12)
    else:
        radius = torch.full((b,), cfg.patch_radius, dtype=queries.dtype,
                            device=queries.device)
    patch_pts_ps = geometry.model_space_to_patch_space(patch_pts_ms, queries,
                                                       radius)

    with trace.span("extract.subsample"):
        if sub_n > 0 and _uniform_mode(cfg, small_cloud):
            if draws.ids is None or tuple(draws.ids.shape) != (b, sub_n):
                shape = None if draws.ids is None else tuple(draws.ids.shape)
                raise ValueError(f"draws.ids has shape {shape}, expected "
                                 f"{(b, sub_n)}")
            sub = points[draws.ids]
        elif sub_n > 0:
            sub_ids, sub_pad = _gumbel_subsample(
                points, queries, n_valid, sub_n, draws, cfg, small_cloud,
                uniform_shuffle=small_cloud)
            sub = torch.where(sub_pad[..., None], 0.0, points[sub_ids])
        else:
            sub = torch.zeros((b, 0, 3), dtype=points.dtype,
                              device=points.device)

    query_ms = queries
    if train:
        rot = draws.rot
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
