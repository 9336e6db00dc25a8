"""Port parity: the data layer (``data/samplers.py``, ``data/shapes.py``,
``data/pipeline.py``) against the JAX package, on the bundled dataset.

The samplers are copies (numpy ``RandomState`` streams) and must give the
same index streams. The shape stores must count, cache and evict alike and
write the same grid-query cache file. The pipeline's batches are compared
with JAX's random draws injected through ``PatchPipeline.draws``
(:func:`inject_jax_draws`): ids exactly, tensors within 1e-5.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.data import pipeline as tpipe
from points2surf_tpu_torch.data import samplers as tsamp
from points2surf_tpu_torch.data import shapes as tshapes
from points2surf_tpu_torch.ops import patches as tp

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.data import pipeline as jpipe  # noqa: E402
from points2surf_tpu.data import samplers as jsamp  # noqa: E402
from points2surf_tpu.data import shapes as jshapes  # noqa: E402
from points2surf_tpu.ops import patches as jp  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
CFG = dict(points_per_patch=16, sub_sample_size=32)


def inject_jax_draws(monkeypatch, pipe, fused_batch=None):
    """Make ``pipe.draws`` return the JAX package's draws for the same step:
    ``fold_in(key(seed), step)``, at JAX's power-of-two run bucket (the
    port's rows are the bucket's first rows) except for a fused train step
    of ``fused_batch`` rows, which JAX draws unpadded. ``pipe.reset()``
    restarts the steps, as JAX's does. Returns the step count (a list of
    one int)."""
    from test_torch_patches import first_rows, jax_draws, jax_train_draws

    step = [0]

    def draws(b, n, small_cloud=False, n_valid=None):
        step[0] += 1
        key = jax.random.fold_in(jax.random.key(pipe.seed), step[0])
        rows = b if b == fused_batch else jpipe._run_bucket(b)
        d = (jax_train_draws if pipe.augment else jax_draws)(
            key, rows, n, pipe.cfg, small_cloud, n_valid)
        return first_rows(d, b).to(pipe.store.device)

    reset = pipe.reset

    def restart():
        step[0] = 0
        reset()

    monkeypatch.setattr(pipe, "draws", draws)
    monkeypatch.setattr(pipe, "reset", restart)
    return step


@pytest.fixture
def exact_jax_selection(monkeypatch):
    monkeypatch.setenv("P2S_EVAL_APPROX_SELECT", "0")
    jax.clear_caches()  # the switch is read at trace time
    yield
    monkeypatch.delenv("P2S_EVAL_APPROX_SELECT")
    jax.clear_caches()


@pytest.mark.parametrize("name,kw", [
    ("RandomPatchSampler", {}),
    ("RandomPatchSampler", {"identical_epochs": True}),
    ("SequentialShapeRandomPatchSampler", {}),
    ("SequentialShapeRandomPatchSampler", {"identical_epochs": True}),
    ("SequentialShapeRandomPatchSampler", {"sequential_shapes": True}),
])
def test_samplers_match_jax(name, kw):
    counts = [2000, 2000, 37]
    j = getattr(jsamp, name)(counts, 48, seed=11, **kw)
    t = getattr(tsamp, name)(counts, 48, seed=11, **kw)
    assert len(t) == len(j)
    for _ in range(3):  # epochs
        np.testing.assert_array_equal(np.fromiter(t, np.int64),
                                      np.fromiter(j, np.int64))
    seq = tsamp.SequentialPatchSampler(counts)
    assert list(seq) == list(jsamp.SequentialPatchSampler(counts))


def _touch(store):
    """One access pattern: gets, cloud uploads, evictions."""
    for i in (0, 1, 0, 1, 1, 0):
        store.get(i)
        store.device_points(i)
    store.get(1)


def test_shape_store_matches_jax(tmp_path):
    j = jshapes.ShapeStore(ABC, "trainset.txt", cache_capacity=1)
    t = tshapes.ShapeStore(ABC, "trainset.txt", cache_capacity=1,
                           device="cpu")
    assert t.shape_names == j.shape_names
    assert t.shape_patch_count == j.shape_patch_count
    assert t.total_patch_count == j.total_patch_count
    _touch(j)
    _touch(t)
    assert t._used_at == j._used_at
    assert list(t._host_cache) == list(j._host_cache)
    assert list(t._device_cache) == list(j._device_cache)
    pts, n = t.device_points(0)
    j_pts, j_n = j.device_points(0)
    assert n == j_n and pts.device.type == "cpu"
    np.testing.assert_array_equal(pts.numpy(), np.asarray(j_pts))


def test_reconstruction_cache_file_matches_jax(tmp_path):
    files = []
    for name, mod, kw in (("jax", jshapes, {}),
                          ("port", tshapes, {"device": "cpu"})):
        root = tmp_path / name
        shutil.copytree(ABC, root)
        store = mod.ShapeStore(str(root), "testset.txt", reconstruction=True,
                               query_grid_resolution=32, epsilon=3, **kw)
        assert store.shape_patch_count == [-1]
        q = store.get(0).query_pts
        assert store.shape_patch_count == [len(q)]
        files.append(list((root / "cache" / "grid_queries_r32_e3")
                          .glob("*.npy")))
    (jf,), (tf,) = files
    assert jf.name == tf.name
    assert jf.read_bytes() == tf.read_bytes()
    # the port reads the JAX package's cache
    shutil.copy(jf, tf)
    t = tshapes.ShapeStore(str(tmp_path / "port"), "testset.txt",
                           reconstruction=True, query_grid_resolution=32,
                           epsilon=3, device="cpu")
    np.testing.assert_array_equal(t.get(0).query_pts, np.load(jf))


def _pipes(monkeypatch, augment, seed=5):
    cap = dict(cache_capacity=4)
    jstore = jshapes.ShapeStore(ABC, "trainset.txt", **cap)
    tstore = tshapes.ShapeStore(ABC, "trainset.txt", device="cpu", **cap)
    j = jpipe.PatchPipeline(jstore, jp.PatchConfig(**CFG), augment=augment,
                            seed=seed)
    t = tpipe.PatchPipeline(tstore, tp.PatchConfig(**CFG), augment=augment,
                            seed=seed)
    steps = inject_jax_draws(monkeypatch, t)
    return j, t, steps


def _assert_batches(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["patch_pts_ids"].numpy(),
                                  np.asarray(want["patch_pts_ids"]))
    for k, v in want.items():
        if k != "patch_pts_ids":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_plan_matches_jax(monkeypatch, exact_jax_selection):
    j, t, steps = _pipes(monkeypatch, augment=True)
    sampler = jsamp.SequentialShapeRandomPatchSampler([2000, 2000], 48,
                                                      seed=3)
    idx = list(sampler)
    jplan, tplan = list(j.plan(idx, 32)), list(t.plan(idx, 32))
    assert [p[0] for p in tplan] == [p[0] for p in jplan] == [
        "single", "mixed", "single"]
    for a, b in zip(tplan, jplan):
        if a[0] == "single":
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
            assert a[3].dtype == np.float32
        else:
            _assert_batches(a[1], b[1])
    assert steps[0] == j._step == 2  # the mixed batch's two runs


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("chunk", [
    np.arange(64),  # one run
    np.concatenate([np.arange(1990, 2000), np.arange(2000, 2010),
                    np.arange(5, 9)]),  # runs of two shapes, interleaved
])
def test_assemble_matches_jax(monkeypatch, exact_jax_selection, augment,
                              chunk):
    j, t, _ = _pipes(monkeypatch, augment)
    want = j._assemble(chunk, True)
    got = t._assemble(chunk, True)
    _assert_batches(got, want)
    assert got["imp_surf_ms"].shape == (len(chunk),)
    # reset restarts the stream: the same batch again
    t.reset()
    again = t._assemble(chunk, True)
    for k, v in got.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_port_draws_on_the_generator():
    """Without injection the draws come from the pipeline's own generator:
    reset() replays them, and augment adds one rotation per row."""
    store = tshapes.ShapeStore(ABC, "trainset.txt", device="cpu")
    pipe = tpipe.PatchPipeline(store, tp.PatchConfig(**CFG), augment=True,
                               seed=1)
    a = pipe.draws(8, 65536)
    b = pipe.draws(8, 65536)
    assert isinstance(a, tp.TrainDraws) and a.rot.shape == (8, 3, 3)
    assert not torch.equal(a.logu, b.logu)
    pipe.reset()
    torch.testing.assert_close(pipe.draws(8, 65536).logu, a.logu, rtol=0,
                               atol=0)
    batch = next(pipe.batches(range(40), 40))
    assert batch["patch_pts_ps"].shape == (40, 16, 3)
