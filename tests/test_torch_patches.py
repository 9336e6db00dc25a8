"""Port parity: ``extract_patches`` against the JAX package, eval and train.

The sub-sample's random draws are made here with ``jax.random`` exactly as
the JAX package makes them (``fold_in`` per query chunk, the decimation
offset from ``fold_in(key, 10_000)``), and in training the augmentation's
rotations too (``geometry.random_rotation`` of the third split of the key),
and injected into the port, so both sides select and rotate alike. JAX's
approximate coherent selection is switched off (``P2S_EVAL_APPROX_SELECT=0``);
the port always selects exactly, and JAX's approximate training selection
(``approx_max_k``) is exact on the CPU.
"""

import dataclasses

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


def jax_ball_draws(key, b, n, cfg):
    """Ball mode's priorities as ``points2surf_tpu.ops.patches`` draws them
    for ``key`` and a batch of ``b`` rows, served block by block: one
    ``uniform(fold_in(k_sel, ti), (tile, M))`` per Morton-ordered tile, and
    for the dense path one ``uniform(fold_in(k_sel, ci), (qc, N))`` per JAX
    query chunk of ``qc`` rows, of which the port's chunk takes its rows."""
    k_sel = jax.random.split(key, 3)[0]
    qc = min(cfg.query_chunk, b)
    while b % qc != 0:
        qc -= 1

    def source(kind, index, shape):
        if kind == "tiles":
            t, tile, m = shape
            u = [np.asarray(jax.random.uniform(jax.random.fold_in(k_sel, ti),
                                               (tile, m))) for ti in range(t)]
            return torch.from_numpy(np.stack(u))
        rows, cols = shape
        first, last = index // qc, (index + rows - 1) // qc
        u = np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(k_sel, ci), (qc, cols)))
            for ci in range(first, last + 1)])
        start = index - first * qc
        return torch.from_numpy(u[start:start + rows].copy())

    return tp.BallDraws(source)


def jax_draws(key, b, n, cfg, small_cloud, n_valid=None):
    """The draws of ``points2surf_tpu.ops.patches`` for ``key``: the
    sub-sample's (the uniform mode's ids below ``max(n_valid, 1)``) and in
    ball mode the selection's priorities."""
    _, sub_key, _ = jax.random.split(key, 3)
    if cfg.fixed_subsample:
        sub_key = jax.random.key(42)
    ball = None if cfg.knn_mode else jax_ball_draws(key, b, n, cfg)
    if cfg.uniform_subsample and not small_cloud:
        ids = np.asarray(jax.random.randint(
            sub_key, (b, cfg.sub_sample_size), 0, max(int(n_valid), 1)))
        return tp.SubsampleDraws(None, None, ids=torch.from_numpy(
            ids.astype(np.int64)), ball=ball)
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
                             torch.from_numpy(np.concatenate(logu)),
                             ball=ball)


def jax_train_draws(key, b, n, cfg, small_cloud=False, n_valid=None):
    """The training-batch draws of ``points2surf_tpu.ops.patches`` for
    ``key``: :func:`jax_draws` and the augmentation's rotations."""
    from points2surf_tpu.ops import geometry as jg

    d = jax_draws(key, b, n, cfg, small_cloud, n_valid)
    rot = np.asarray(jg.random_rotation(jax.random.split(key, 3)[2], (b,)))
    return tp.TrainDraws(d.offset, d.logu, torch.from_numpy(rot.copy()),
                         ids=d.ids, ball=d.ball)


def first_rows(d, b):
    """Draws ``d`` of a JAX batch cut to its first ``b`` rows (JAX pads a
    pipeline run to a power-of-two bucket)."""
    cut = {f: getattr(d, f)[:b] for f in ("logu", "ids", "rot")
           if getattr(d, f, None) is not None}
    return dataclasses.replace(d, **cut)


def _cloud(rng, n=N):
    return (rng.rand(n, 3) * 1.6 - 0.8).astype(np.float32)


def _compare(pts, q, n_valid, cfg_kw, small_cloud=False, coherent=True,
             train=False):
    key = jax.random.key(3)
    jcfg = jp.PatchConfig(**cfg_kw)
    tcfg = tp.PatchConfig(**cfg_kw)
    want = jp.extract_patches(jnp.asarray(pts), jnp.asarray(q),
                              jnp.int32(n_valid), key, cfg=jcfg, train=train,
                              small_cloud=small_cloud, coherent=coherent)
    draws = (jax_train_draws if train else jax_draws)(
        key, len(q), len(pts), tcfg, small_cloud)
    got = tp.extract_patches(torch.from_numpy(pts), torch.from_numpy(q),
                             n_valid, draws, cfg=tcfg, train=train,
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
    t = torch.all(t)
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


def test_train_path_matches_jax(rng):
    """Train mode: full-cloud selection (no tile attempt even for a tight
    block of queries), rotated patch, sub-sample and query."""
    pts = _cloud(rng)
    q = (rng.rand(B, 3) * 0.2 - 0.1).astype(np.float32)
    got = _compare(pts, q, N, KW, train=True)
    # the rotation keeps the patch-space normalization (max norm 1)
    norms = torch.linalg.vector_norm(got["patch_pts_ps"], dim=-1)
    np.testing.assert_allclose(norms.amax(1).numpy(), 1.0, atol=1e-6)


def test_train_small_cloud_matches_jax(rng):
    n_valid = 50
    pts = _cloud(rng)
    pts[n_valid:] = 0.0
    _compare(pts, _cloud(rng, B), n_valid, KW, small_cloud=True, train=True)


def test_port_draws_shape_and_range():
    cfg = tp.PatchConfig(**KW)
    gen = torch.Generator().manual_seed(0)
    d = tp.draw_subsample(gen, 8, N, cfg)
    stride, n_cand = tp.subsample_candidates(N, cfg, False)
    assert d.logu.shape == (8, n_cand) and 0 <= int(d.offset) < stride
    assert bool((d.logu < 0).all()) and bool(torch.isfinite(d.logu).all())
    t = tp.draw_batch(gen, 8, N, cfg, train=True)
    assert t.logu.shape == (8, n_cand) and t.rot.shape == (8, 3, 3)
    eye = torch.eye(3).expand(8, 3, 3)
    torch.testing.assert_close(t.rot @ t.rot.transpose(1, 2), eye,
                               atol=1e-5, rtol=0)


def test_unported_modes_raise(rng):
    """Ball mode and the uniform sub-sample, once raising, now extract (from
    a Generator, in eval and train mode); train mode without the rotations
    still raises, and so does ball mode without its priorities."""
    pts = torch.from_numpy(_cloud(rng))
    gen = torch.Generator().manual_seed(0)
    k, s = KW["points_per_patch"], KW["sub_sample_size"]
    for kw in ({"patch_radius": 0.1}, {"uniform_subsample": True}):
        cfg = tp.PatchConfig(**KW, **kw)
        for train in (False, True):
            out = tp.extract_patches(pts, pts[:4], N, gen, cfg=cfg,
                                     train=train)
            assert out["patch_pts_ps"].shape == (4, k, 3)
            assert out["pts_sub_sample_ms"].shape == (4, s, 3)
            assert bool(torch.isfinite(out["patch_pts_ps"]).all())
            if cfg.knn_mode and not train:  # rows of the cloud itself
                sub = out["pts_sub_sample_ms"][:, :, None, :]
                assert bool((sub == pts).all(-1).any(-1).all())
            elif not cfg.knn_mode:  # the fixed radius
                assert torch.equal(out["patch_radius_ms"],
                                   torch.full((4,), 0.1))
    # train mode needs the rotations: a Generator or TrainDraws
    cfg = tp.PatchConfig(**KW)
    draws = tp.draw_subsample(gen, 4, N, cfg)
    with pytest.raises(TypeError):
        tp.extract_patches(pts, pts[:4], N, draws, cfg=cfg, train=True)
    with pytest.raises(TypeError):  # ball mode needs its priorities
        tp.extract_patches(pts, pts[:4], N, draws,
                           cfg=tp.PatchConfig(**KW, patch_radius=0.1))
    with pytest.raises(ValueError):  # the uniform ids need n_valid
        tp.draw_subsample(gen, 4, N, tp.PatchConfig(**KW,
                                                    uniform_subsample=True))
    out = tp.extract_patches(pts, pts[:4], N, gen, cfg=cfg, train=True)
    assert out["patch_pts_ps"].shape == (4, KW["points_per_patch"], 3)
