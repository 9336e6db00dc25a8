"""Port parity: the extraction options against the JAX package.

* Ball mode (``patch_radius > 0``) on the tile path, its whole-batch dense
  fallback, the dense path and in training, at r = 0.05 (most balls hold
  fewer points than the patch, so pad slots are common) and r = 0.2, with
  JAX's uniform priorities injected (``jax_ball_draws``): per row the same
  in-ball ids as sets, the same pad slots, every output tensor within 1e-6;
  the certificates equal; the candidate depth rule equal on a grid.
* The uniform with-replacement sub-sample with JAX's ids injected: exact.
* ``ops/subsample.subsample_batch``: the streamed form, in its three modes:
  with JAX's Gumbel uniforms injected the same points as JAX's; without, the
  reference's inclusion frequencies (as ``tests/test_subsample.py``), ids in
  range, zero padding.
* One ``Trainer`` epoch and an evaluator pass (eval and reconstruction) in
  ball mode and in uniform mode against JAX's, with injected draws:
  logged losses rtol 1e-3, written distances 1e-4.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.ops import subsample as tsub

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from points2surf_tpu.ops import patches as jp  # noqa: E402
from test_torch_evaluator import jax_exact  # noqa: E402,F401 (fixture)
from test_torch_patches import (  # noqa: E402
    jax_ball_draws, jax_draws, jax_train_draws)
from test_torch_trainer import jax_cpu_kernels  # noqa: E402,F401 (fixture)

N = 8192
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


def _cloud(rng, n=N):
    return (rng.rand(n, 3) * 1.6 - 0.8).astype(np.float32)


def _block(rng, b=B):
    return (rng.rand(b, 3) * 0.2 - 0.1).astype(np.float32)


def _in_ball(batch):
    """Slots that hold a point (pad slots sit on the query: the origin)."""
    return np.any(np.asarray(batch["patch_pts_ps"]) != 0.0, axis=-1)


def _compare(pts, q, n_valid, cfg_kw, train=False, coherent=True,
             small_cloud=False):
    key = jax.random.key(5)
    jcfg, tcfg = jp.PatchConfig(**cfg_kw), tp.PatchConfig(**cfg_kw)
    want = jp.extract_patches(jnp.asarray(pts), jnp.asarray(q),
                              jnp.int32(n_valid), key, cfg=jcfg, train=train,
                              small_cloud=small_cloud, coherent=coherent)
    draws = (jax_train_draws if train else jax_draws)(
        key, len(q), len(pts), tcfg, small_cloud, n_valid)
    got = tp.extract_patches(torch.from_numpy(pts), torch.from_numpy(q),
                             n_valid, draws, cfg=tcfg, train=train,
                             small_cloud=small_cloud, coherent=coherent)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    if not tcfg.knn_mode:
        valid = _in_ball(want)
        np.testing.assert_array_equal(_in_ball(got), valid)
        for row in range(len(q)):
            assert (set(got["patch_pts_ids"][row][valid[row]])
                    == set(want["patch_pts_ids"][row][valid[row]])), row
    else:
        np.testing.assert_array_equal(got["patch_pts_ids"],
                                      want["patch_pts_ids"])
    for k in ("patch_pts_ps", "patch_radius_ms", "pts_sub_sample_ms",
              "imp_surf_query_point_ms", "imp_surf_query_point_ps"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    return got


def _certified(pts, q, r):
    """The port's and JAX's whole-batch ball-mode tile certificates."""
    cfg_kw = dict(KW, patch_radius=r)
    jcfg, tcfg = jp.PatchConfig(**cfg_kw), tp.PatchConfig(**cfg_kw)
    m = tp._ball_tile_candidates(tcfg, len(pts))
    key = jax.random.key(1)
    k, tile = tcfg.points_per_patch, tcfg.tile_queries
    j = jp._tile_select(jnp.asarray(pts), jnp.asarray(q), jnp.int32(len(pts)),
                        k, jcfg, tile, jax.random.split(key, 3)[0], m=m)[3]
    t = tp._tile_select(torch.from_numpy(pts), torch.from_numpy(q), len(pts),
                        k, tile, m, r, jax_ball_draws(key, len(q), len(pts),
                                                      tcfg))[2]
    t = torch.all(t)
    assert bool(t) == bool(j)
    return bool(t)


@pytest.mark.parametrize("n", [1000, 8192, 60000, 65536, 150000])
@pytest.mark.parametrize("r", [0.01, 0.05, 0.1, 0.2, 0.5])
@pytest.mark.parametrize("tile_candidates", [256, 8192])
def test_ball_tile_candidates_match_jax(n, r, tile_candidates):
    kw = dict(patch_radius=r, tile_candidates=tile_candidates)
    assert (tp._ball_tile_candidates(tp.PatchConfig(**kw), n)
            == jp._ball_tile_candidates(jp.PatchConfig(**kw), n))


def test_ball_tile_candidates_bundled_cloud():
    """The bundled cloud padded to 65,536 rows at the default depth."""
    depth = {r: tp._ball_tile_candidates(tp.PatchConfig(patch_radius=r),
                                         65536) for r in (0.05, 0.1, 0.2)}
    assert depth == {0.05: 8192, 0.1: 18432, 0.2: 18432}


@pytest.mark.parametrize("r", [0.05, 0.2])
def test_ball_tile_path_matches_jax(rng, r):
    pts, q = _cloud(rng), _block(rng)
    assert _certified(pts, q, r)
    _compare(pts, q, N, dict(KW, patch_radius=r))


@pytest.mark.parametrize("r", [0.05, 0.2])
def test_ball_dense_fallback_matches_jax(rng, r):
    pts, q = _cloud(rng), _cloud(rng, B)  # spread: the tiles fail
    assert not _certified(pts, q, r)
    _compare(pts, q, N, dict(KW, patch_radius=r))


@pytest.mark.parametrize("r", [0.05, 0.2])
def test_ball_dense_and_train_paths_match_jax(rng, r):
    """Spread queries without the tile attempt (eval), and train mode: the
    full cloud with JAX's query chunks (1000 rows: two of 500, against the
    port's 512 + 488), rotated; a cloud with padding rows."""
    pts, q = _cloud(rng), _cloud(rng, 1000)
    cfg_kw = dict(KW, patch_radius=r)
    _compare(pts, q[:B], N, cfg_kw, coherent=False)
    pts[N - 100:] = 0.0
    got = _compare(pts, q, N - 100, cfg_kw, train=True)
    assert int(got["patch_pts_ids"][_in_ball(got)].max()) < N - 100


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fixed", [False, True])
def test_uniform_subsample_matches_jax(rng, exact_jax_selection, train,
                                       fixed):
    """Ids with replacement below n_valid, JAX's injected: exact; kNN
    selection; fixed_subsample draws them from key 42."""
    n_valid = N - 300
    pts = _cloud(rng)
    pts[n_valid:] = 0.0
    cfg_kw = dict(KW, uniform_subsample=True, fixed_subsample=fixed)
    got = _compare(pts, _block(rng), n_valid, cfg_kw, train=train)
    if not train:
        sub = got["pts_sub_sample_ms"]
        assert not np.any(np.all(sub == 0.0, axis=-1))  # valid rows only


def test_uniform_subsample_small_cloud_matches_jax(rng, exact_jax_selection):
    """A cloud smaller than the sub-sample keeps the shuffle and the zero
    padding in uniform mode."""
    n_valid = 50
    pts = _cloud(rng)
    pts[n_valid:] = 0.0
    got = _compare(pts, _block(rng), n_valid,
                   dict(KW, uniform_subsample=True), small_cloud=True)
    sub = got["pts_sub_sample_ms"]
    assert ((np.abs(sub).sum(-1) == 0).sum(1) == 64 - n_valid).all()


def test_ball_draws_on_the_generator():
    """draw_batch in ball mode: the priorities come from the generator as
    the selection asks for them, so a reseeded generator replays them."""
    cfg = tp.PatchConfig(**KW, patch_radius=0.2)
    pts = torch.from_numpy(_cloud(np.random.RandomState(1)))
    q = torch.from_numpy(_block(np.random.RandomState(2)))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        d = tp.draw_batch(gen, B, N, cfg, train=True)
        assert d.ball is not None and d.ids is None
        outs.append(tp.extract_patches(pts, q, N, d, cfg=cfg, train=True))
    for k, v in outs[0].items():
        torch.testing.assert_close(outs[1][k], v, rtol=0, atol=0)
    u = tp.BallDraws.from_generator(torch.Generator().manual_seed(0))
    block = u.block("rows", 0, (4, 8))
    assert block.shape == (4, 8) and bool(((block >= 0) & (block < 1)).all())
    with pytest.raises(ValueError):
        tp.BallDraws(lambda kind, i, shape: torch.zeros(3)).block(
            "rows", 0, (4, 8))


# --------------------------------------------------- ops/subsample.py


def _jax_gumbel_uniforms(key, b, chunk):
    """JAX's uniforms of column chunk ci: ``uniform(fold_in(key, ci))``."""
    def uniforms(ci, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, ci), shape,
            minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
    return uniforms


@pytest.mark.parametrize("small_cloud", [False, True])
def test_subsample_batch_matches_jax(rng, small_cloud):
    """With JAX's uniforms injected, the streamed form selects JAX's
    points: distance-weighted over 700 valid rows of 1,000 in chunks of
    256, or a small cloud (30 valid rows) shuffled and zero-padded."""
    from points2surf_tpu.ops.subsample import subsample_batch

    n_valid = 30 if small_cloud else 700
    pts = rng.randn(1000, 3).astype(np.float32)
    q = rng.randn(6, 3).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(subsample_batch(
        jnp.asarray(pts), jnp.asarray(q), n_valid, 48, key,
        small_cloud=small_cloud, chunk=256))
    got = tsub.subsample_batch(
        torch.from_numpy(pts), torch.from_numpy(q), n_valid, 48,
        _jax_gumbel_uniforms(key, 6, 256), small_cloud=small_cloud,
        chunk=256).numpy()
    assert got.shape == want.shape == (6, 48, 3)
    for row in range(6):  # as point sets: the order is the score order
        a = {tuple(p) for p in got[row]}
        assert a == {tuple(p) for p in want[row]}, row
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_subsample_batch_dist_weighted_distribution(rng):
    """The Gumbel top-n reproduces numpy.choice(replace=False,
    p=dist_prob) (reference utils.py:200-208), as tests/test_subsample.py
    holds the JAX package's."""
    from test_subsample import _dist_prob

    pts = rng.rand(400, 3).astype(np.float32)
    q = np.array([[0.5, 0.5, 0.5]], np.float32)
    n, trials = 40, 400
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(400)
    for _ in range(trials):
        sel = tsub.subsample_batch(torch.from_numpy(pts), torch.from_numpy(q),
                                   400, n, gen, chunk=128).numpy()[0]
        counts[np.linalg.norm(sel[:, None] - pts[None], axis=-1).argmin(1)] \
            += 1
    ref = np.zeros(400)
    ref_rng = np.random.RandomState(7)
    p = _dist_prob(pts, q[0])
    for _ in range(trials):
        ref[ref_rng.choice(400, size=n, replace=False, p=p)] += 1
    assert np.corrcoef(counts, ref)[0, 1] > 0.9
    assert counts.sum() == n * trials  # without replacement: n distinct


def test_subsample_batch_uniform_and_small_cloud(rng):
    pts = rng.randn(1000, 3).astype(np.float32)
    q = rng.randn(4, 3).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    out = tsub.subsample_batch(torch.from_numpy(pts), torch.from_numpy(q),
                               600, 64, gen, mode="uniform", chunk=256)
    assert out.shape == (4, 64, 3)
    member = (out[:, :, None, :] == torch.from_numpy(pts[:600])).all(-1)
    assert bool(member.any(-1).all())  # valid rows of the cloud only
    # with replacement: 4 x 64 draws from 600 repeat some rows
    flat = out.reshape(-1, 3)
    assert len(torch.unique(flat, dim=0)) < len(flat)
    small = np.zeros((64, 3), np.float32)
    small[:10] = rng.randn(10, 3)
    for mode in ("dist_weighted", "uniform"):
        out = tsub.subsample_batch(torch.from_numpy(small),
                                   torch.from_numpy(q[:2]), 10, 16, gen,
                                   mode=mode, small_cloud=True,
                                   chunk=32).numpy()
        for b in range(2):  # each valid point once, the rest zero
            nonzero = out[b][np.abs(out[b]).sum(1) > 0]
            assert len({tuple(p) for p in nonzero}) == 10
            assert (np.abs(out[b]).sum(1) == 0).sum() == 6
    with pytest.raises(ValueError):
        tsub.subsample_batch(torch.from_numpy(pts), torch.from_numpy(q), 600,
                             8, gen, mode="nearest")


# ---------------------------------------- the trainer and the evaluator


OPTIONS = {
    "ball": dict(patch_radius=0.05),
    "uniform": dict(uniform_subsample=1),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_trainer_epoch_matches_jax(tmp_path, monkeypatch, jax_cpu_kernels,
                                   option):
    """One epoch of ``tests/test_torch_trainer.py``'s run in the option,
    JAX's draws injected (the ball priorities, the uniform ids)."""
    from test_torch_data import inject_jax_draws
    from test_torch_trainer import RecordingWriter, _assert_logs, train_opt

    from points2surf_tpu.train import checkpoint as jckpt
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer
    from points2surf_tpu_torch.train.trainer import Trainer as TorchTrainer

    kw = dict(OPTIONS[option], nepoch=1)
    fresh = str(tmp_path / "fresh" / "t_model.npz")
    jckpt.save_state(fresh, JaxTrainer(train_opt(
        str(tmp_path / "init"), **kw)).state_dict())
    kw["refine"] = fresh
    jw = RecordingWriter()
    JaxTrainer(train_opt(str(tmp_path / "jax"), **kw), log_writer=jw).train()
    tw = RecordingWriter()
    tt = TorchTrainer(train_opt(str(tmp_path / "port"), **kw), log_writer=tw,
                      device="cpu")
    assert tt.fixed_radius == (option == "ball")
    inject_jax_draws(monkeypatch, tt.train_pipe, fused_batch=32)
    inject_jax_draws(monkeypatch, tt.test_pipe)
    tt.train()
    assert {"loss/train/total", "loss/eval/total"} <= {
        t for t, _, _ in tw.scalars}
    _assert_logs(tw.scalars, jw.scalars)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_evaluator_pass_matches_jax(tmp_path, monkeypatch, jax_exact,
                                    option):
    """An eval pass and a reconstruction pass (grid 32: the ball-mode tile
    path at batch 512) of one JAX-written checkpoint trained in the
    option: the same files, distances within 1e-4."""
    from test_torch_evaluator import _eval_opt, _files, _inject_jax_draws
    from test_torch_trainer import train_opt

    from points2surf_tpu.infer.evaluator import points_to_surf_eval
    from points2surf_tpu.train import checkpoint as jckpt
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer
    from points2surf_tpu_torch.infer import evaluator as tev

    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(os.path.dirname(__file__), "..",
                                 "datasets", "abc_minimal"), data)
    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"), **OPTIONS[option])
    jckpt.save_state(os.path.join(models, "t_model.npz"),
                     JaxTrainer(opt).state_dict())
    jckpt.save_params_namespace(os.path.join(models, "t_params.json"),
                                opt)
    for rec in (False, True):
        outs = {}
        for pkg in ("jax", "port"):
            e_opt = _eval_opt(data, models, str(tmp_path / pkg), rec)
            if pkg == "jax":
                points_to_surf_eval(e_opt)
            else:
                _inject_jax_draws(monkeypatch, jax, e_opt.seed)
                tev.points_to_surf_eval(e_opt, device="cpu")
            outs[pkg] = os.path.join(e_opt.outdir,
                                     "rec" if rec else "eval")
        files = _files(outs["jax"])
        assert _files(outs["port"]) == files
        dists = [f for f in files if f.endswith(".xyz.npy")]
        assert dists
        for f in dists:
            a, b = (np.load(os.path.join(outs[p], f))
                    for p in ("port", "jax"))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f)


def test_trainer_ball_mode_on_the_generator(tmp_path):
    """The reference's default training config (ball mode, r = 0.05) and
    the uniform sub-sample train from the pipeline's own generator, and a
    reset replays an epoch's first batch."""
    from test_torch_trainer import train_opt

    from points2surf_tpu_torch.train.trainer import Trainer

    for kw in OPTIONS.values():
        tr = Trainer(train_opt(str(tmp_path), **kw), device="cpu")
        tr.train()
        assert tr.global_step == 3
        pipe = tr.train_pipe
        pipe.reset()
        first = next(pipe.batches(range(40), 40))
        pipe.reset()
        again = next(pipe.batches(range(40), 40))
        for k, v in first.items():
            torch.testing.assert_close(again[k], v, rtol=0, atol=0)
