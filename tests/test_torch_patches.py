"""Port parity: eval-mode ``extract_patches`` against the JAX package.

The sub-sample's random draws are made here with ``jax.random`` exactly as
the JAX package makes them (``fold_in`` per query chunk, the decimation
offset from ``fold_in(key, 10_000)``) and injected into the port, so both
sides select the same sub-sample. JAX's approximate coherent selection is
switched off (``P2S_EVAL_APPROX_SELECT=0``); the port always selects
exactly.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import patches as tp

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from points2surf_tpu.ops import patches as jp  # noqa: E402

N = 2048
B = 128
KW = dict(points_per_patch=16, sub_sample_size=64, tile_candidates=256,
          tile_queries=32, subsample_candidates=4)


@pytest.fixture
def exact_jax_selection(monkeypatch):
    monkeypatch.setenv("P2S_EVAL_APPROX_SELECT", "0")
    jax.clear_caches()  # the switch is read at trace time
    yield
    monkeypatch.delenv("P2S_EVAL_APPROX_SELECT")
    jax.clear_caches()


def jax_draws(key, b, n, cfg, small_cloud):
    """The sub-sample draws of ``points2surf_tpu.ops.patches`` for ``key``."""
    _, sub_key, _ = jax.random.split(key, 3)
    stride, n_cand = tp.subsample_candidates(n, cfg, small_cloud)
    offset = 0
    if stride:
        offset = int(jax.random.randint(
            jax.random.fold_in(sub_key, 10_000), (), 0, stride))
    qc = min(cfg.query_chunk * 4, b)
    while b % qc != 0:
        qc -= 1
    logu = [np.asarray(jnp.log(jax.random.uniform(
        jax.random.fold_in(sub_key, ci), (qc, n_cand),
        minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
        for ci in range(b // qc)]
    return tp.SubsampleDraws(torch.tensor(offset),
                             torch.from_numpy(np.concatenate(logu)))


def _cloud(rng, n=N):
    return (rng.rand(n, 3) * 1.6 - 0.8).astype(np.float32)


def _compare(pts, q, n_valid, cfg_kw, small_cloud=False, coherent=True):
    key = jax.random.key(3)
    jcfg = jp.PatchConfig(**cfg_kw)
    tcfg = tp.PatchConfig(**cfg_kw)
    want = jp.extract_patches(jnp.asarray(pts), jnp.asarray(q),
                              jnp.int32(n_valid), key, cfg=jcfg, train=False,
                              small_cloud=small_cloud, coherent=coherent)
    draws = jax_draws(key, len(q), len(pts), tcfg, small_cloud)
    got = tp.extract_patches(torch.from_numpy(pts), torch.from_numpy(q),
                             n_valid, draws, cfg=tcfg,
                             small_cloud=small_cloud, coherent=coherent)
    # selection is deterministic: no pad slots here (n_valid >= k)
    np.testing.assert_array_equal(got["patch_pts_ids"].numpy(),
                                  np.asarray(want["patch_pts_ids"]))
    for k in ("patch_pts_ps", "patch_radius_ms", "pts_sub_sample_ms",
              "imp_surf_query_point_ms", "imp_surf_query_point_ps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    return got


def _certified(pts, q, n_valid, cfg_kw):
    """The port's and JAX's whole-batch tile certificates."""
    jcfg = jp.PatchConfig(**cfg_kw)
    tcfg = tp.PatchConfig(**cfg_kw)
    k, tile, m = tcfg.points_per_patch, tcfg.tile_queries, tcfg.tile_candidates
    j = jp._tile_select(jnp.asarray(pts), jnp.asarray(q), jnp.int32(n_valid),
                        k, jcfg, tile, jax.random.key(0), m=m)[3]
    t = tp._tile_select(torch.from_numpy(pts), torch.from_numpy(q), n_valid,
                        k, tile, m)[2]
    assert bool(t) == bool(j)
    return bool(t)


def test_certified_tile_path(rng, exact_jax_selection):
    pts = _cloud(rng)
    q = (rng.rand(B, 3) * 0.2 - 0.1).astype(np.float32)  # one tight block
    assert _certified(pts, q, N, KW)
    _compare(pts, q, N, KW)


def test_whole_batch_dense_fallback(rng, exact_jax_selection):
    pts = _cloud(rng)
    q = _cloud(rng, B)  # spread: tiles cannot certify
    assert not _certified(pts, q, N, KW)
    _compare(pts, q, N, KW)


def test_dense_path_without_tiles(rng, exact_jax_selection):
    pts = _cloud(rng)
    q = _cloud(rng, B)
    _compare(pts, q, N, KW, coherent=False)


def test_small_cloud_path(rng, exact_jax_selection):
    n_valid = 50  # < sub_sample_size: shuffle + zero-padded sub-sample
    pts = _cloud(rng)
    pts[n_valid:] = 0.0
    q = (rng.rand(B, 3) * 0.2 - 0.1).astype(np.float32)
    got = _compare(pts, q, n_valid, KW, small_cloud=True)
    sub = got["pts_sub_sample_ms"].numpy()
    assert ((np.abs(sub).sum(-1) == 0).sum(1) == 64 - n_valid).all()


def test_port_draws_shape_and_range():
    cfg = tp.PatchConfig(**KW)
    gen = torch.Generator().manual_seed(0)
    d = tp.draw_subsample(gen, 8, N, cfg)
    stride, n_cand = tp.subsample_candidates(N, cfg, False)
    assert d.logu.shape == (8, n_cand) and 0 <= int(d.offset) < stride
    assert bool((d.logu < 0).all()) and bool(torch.isfinite(d.logu).all())


def test_unported_modes_raise(rng):
    pts = torch.from_numpy(_cloud(rng))
    gen = torch.Generator().manual_seed(0)
    for kw, train in (({}, True), ({"patch_radius": 0.1}, False),
                      ({"uniform_subsample": True}, False)):
        with pytest.raises(NotImplementedError):
            tp.extract_patches(pts, pts[:4], N, gen,
                               cfg=tp.PatchConfig(**KW, **kw), train=train)
