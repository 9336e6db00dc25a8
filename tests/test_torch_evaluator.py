"""Port parity: the evaluator (``infer/evaluator.py``) and the metrics
(``evalx/metrics.py``) against the JAX package.

Both evaluators load one JAX-written checkpoint (a JAX ``Trainer``'s fresh
state and its parameter JSON) and run an eval pass (augmented, a random
subset of each shape's GT queries with ``.idx`` files) and a reconstruction
pass (grid 32) over the bundled dataset, with JAX's random draws injected
into the port (``evaluator.draw_batch``). They must write the same file
set, equal ``.idx`` files and ``.xyz.npy`` distances within 1e-4, and the
port's MSE and Hausdorff/Chamfer CSVs must equal JAX's byte for byte on the
same inputs.

The inference dtype follows the JAX package's rule (``test_eval_dtype``);
bf16 activations are held against JAX in ``tests/test_torch_dtype.py``, ball
mode and the uniform sub-sample in ``tests/test_torch_options.py``.

``cuda``-marked: the evaluator on the card against the CPU with the same
draws, at the query slice's tolerance (rtol 1e-3, atol 1e-4), the chain
kernels launched.
"""

import argparse
import os
import shutil

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.evalx import metrics as tmetrics
from points2surf_tpu_torch.infer import evaluator as tev
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.train import checkpoint as tckpt
from test_torch_trainer import train_opt

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
BATCH = 64
REC_BATCH = 512


def _eval_opt(indir, modeldir, outdir, reconstruction):
    d = dict(
        indir=indir, outdir=outdir, dataset="valset.txt",
        reconstruction=reconstruction, query_grid_resolution=None,
        epsilon=None, modeldir=modeldir, models="t",
        modelpostfix="_model.npz", parampostfix="_params.json",
        sampling="sequential_shapes_random_patches", patches_per_shape=100,
        seed=40938661, batchSize=BATCH, cache_capacity=5,
        exact_patch_sampling=0, eval_dtype="auto",
    )
    if reconstruction:
        d.update(dataset="testset.txt", query_grid_resolution=32, epsilon=3,
                 sampling="full", batchSize=REC_BATCH)
    return argparse.Namespace(**d)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _inject_jax_draws(monkeypatch, jax, seed):
    """``evaluator.draw_batch`` -> the JAX evaluator's draws of the same
    batch: ``fold_in(key(seed), step)``, one step per batch."""
    from test_torch_patches import jax_draws, jax_train_draws

    step = [0]

    def draw_batch(gen, b, n, cfg, small_cloud=False, train=False,
                   n_valid=None):
        step[0] += 1
        key = jax.random.fold_in(jax.random.key(seed), step[0])
        return (jax_train_draws if train else jax_draws)(key, b, n, cfg,
                                                         small_cloud, n_valid)

    monkeypatch.setattr(tev, "draw_batch", draw_batch)


@pytest.fixture
def jax_exact(monkeypatch):
    """JAX's exact eval selection, on one device: the sweep sharded over
    the tests' eight virtual CPU devices costs five times as long."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX package's models need it
    from points2surf_tpu.parallel import mesh

    make_mesh = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda devices=None: make_mesh(jax.devices()[:1]))
    monkeypatch.setenv("P2S_EVAL_APPROX_SELECT", "0")
    jax.clear_caches()
    yield jax
    monkeypatch.delenv("P2S_EVAL_APPROX_SELECT")
    jax.clear_caches()


def test_evaluator_matches_jax(tmp_path, monkeypatch, jax_exact):
    jax = jax_exact
    from points2surf_tpu.evalx import metrics as jmetrics
    from points2surf_tpu.infer.evaluator import points_to_surf_eval
    from points2surf_tpu.train import checkpoint as jckpt
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer

    data = str(tmp_path / "data")
    shutil.copytree(ABC, data)
    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"))
    jckpt.save_state(os.path.join(models, "t_model.npz"),
                     JaxTrainer(opt).state_dict())
    jckpt.save_params_namespace(os.path.join(models, "t_params.json"), opt)

    for rec in (False, True):
        outs = {}
        for pkg in ("jax", "port"):
            e_opt = _eval_opt(data, models, str(tmp_path / pkg), rec)
            if pkg == "jax":
                points_to_surf_eval(e_opt)
            else:
                _inject_jax_draws(monkeypatch, jax, e_opt.seed)
                tev.points_to_surf_eval(e_opt, device="cpu")
            outs[pkg] = os.path.join(e_opt.outdir, "rec" if rec else "eval")
        files = _files(outs["jax"])
        assert _files(outs["port"]) == files
        for f in files:
            a, b = (os.path.join(outs[p], f) for p in ("port", "jax"))
            if f.endswith(".idx"):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), f
            elif f.endswith(".xyz.npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), rtol=0,
                                           atol=1e-4, err_msg=f)
        assert any(f.endswith(".idx") for f in files) != rec

    # the metrics on the same (JAX-written) inputs: byte-identical CSVs
    gt = os.path.join(data, "05_query_dist")
    pred = str(tmp_path / "pred")
    os.makedirs(pred)
    rng = np.random.RandomState(0)
    for f in sorted(os.listdir(gt))[:2]:
        d = np.load(os.path.join(gt, f))
        d = np.where(rng.rand(len(d)) < 0.1, 0.0, d * 0.9 + 0.01)
        np.save(os.path.join(pred, f[:-8] + ".xyz.npy"), d.astype(np.float32))
    rec_dir = str(tmp_path / "jax" / "rec")
    mesh_dir = os.path.join(data, "03_meshes")
    for mod, name in ((jmetrics, "jax"), (tmetrics, "port")):
        mod.eval_predictions(pred, gt, str(tmp_path / f"{name}_mse.csv"))
        mod.mesh_comparison(mesh_dir, mesh_dir, 1,
                            str(tmp_path / f"{name}_hd.csv"),
                            samples_per_model=2000,
                            dataset_file_abs=os.path.join(data, "trainset.txt"))
    for kind in ("mse", "hd"):
        with open(tmp_path / f"port_{kind}.csv", "rb") as a, \
                open(tmp_path / f"jax_{kind}.csv", "rb") as b:
            assert a.read() == b.read(), kind
    assert os.listdir(os.path.join(rec_dir, "dist_ms"))


def test_postprocess_skips_debug_outputs():
    """The reference's output list carries the debug outputs
    ``patch_pts_ids`` and ``p_index``, which hold no prediction column."""
    from points2surf_tpu_torch.infer.query import postprocess_sdf

    pred = torch.tensor([[0.5, -2.0], [1.0, 3.0]])
    radius = torch.tensor([2.0, 1.0])
    want = postprocess_sdf(pred, radius, ("imp_surf_magnitude",
                                          "imp_surf_sign"), False)
    got = postprocess_sdf(pred, radius, ("imp_surf_magnitude", "imp_surf_sign",
                                         "patch_pts_ids", "p_index"), False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[0]) < 0 < float(got[1])
    np.testing.assert_allclose(
        tev.post_process(pred.numpy(), ("imp_surf_magnitude", "p_index",
                                        "imp_surf_sign"), 2.0, False)[:, 0],
        np.tanh(pred[:, 0].numpy()) ** 2 * 2.0, rtol=1e-6)


@pytest.mark.parametrize("train_dtype,eval_dtype,env,want", [
    ("float32", "auto", None, None),
    ("float32", "bfloat16", None, torch.bfloat16),
    ("bfloat16", "auto", None, torch.bfloat16),
    ("bfloat16", "float32", None, None),  # a JAX model trained in bf16
    ("float32", "auto", "bfloat16", torch.bfloat16),  # P2S_EVAL_DTYPE
    ("bfloat16", "auto", "float32", None),
    ("bfloat16", "float32", "bfloat16", None),  # the flag wins
])
def test_eval_dtype(tmp_path, monkeypatch, train_dtype, eval_dtype, env,
                    want):
    """The inference activation dtype: --eval_dtype, with 'auto'
    P2S_EVAL_DTYPE, with 'auto' again the checkpoint's train_dtype (the JAX
    package's rule); parameters stay float32 and the options unchanged."""
    from points2surf_tpu_torch.train.trainer import Trainer

    if env is not None:
        monkeypatch.setenv("P2S_EVAL_DTYPE", env)
    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"))
    tckpt.save_state(os.path.join(models, "t_model.npz"),
                     Trainer(opt, device="cpu").state_dict())
    opt.train_dtype = train_dtype
    tckpt.save_params_namespace(os.path.join(models, "t_params.json"), opt)
    e_opt = _eval_opt(ABC, models, str(tmp_path / "out"), False)
    e_opt.eval_dtype = eval_dtype
    model, t_opt = tev.load_model_for_eval(e_opt, "t", device="cpu")
    assert t_opt.train_dtype == train_dtype and not model.training
    assert model.act_dtype == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rec", [False, True])
def test_evaluator_on_cuda_matches_cpu(tmp_path, monkeypatch, cuda_device,
                                       rec):
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.train.trainer import Trainer

    data = str(tmp_path / "data")
    shutil.copytree(ABC, data)
    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"))
    tckpt.save_state(os.path.join(models, "t_model.npz"),
                     Trainer(opt, device="cpu").state_dict())
    tckpt.save_params_namespace(os.path.join(models, "t_params.json"), opt)
    outs, launches = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        gen = torch.Generator().manual_seed(7)

        def draw_batch(g, b, n, cfg, small_cloud=False, train=False,
                       n_valid=None):
            d = tp.draw_batch(gen, b, n, cfg, small_cloud, train, n_valid)
            return d.to(dev)

        monkeypatch.setattr(tev, "draw_batch", draw_batch)
        e_opt = _eval_opt(data, models, str(tmp_path / dev.type), rec)
        chain_pool.launches = chain_head.launches = 0
        tev.points_to_surf_eval(e_opt, device=dev)
        launches[dev.type] = (chain_pool.launches, chain_head.launches)
        outs[dev.type] = os.path.join(e_opt.outdir, "rec" if rec else "eval")
    assert min(launches["cuda"]) > 0 and max(launches["cpu"]) == 0
    files = [f for f in _files(outs["cpu"]) if f.endswith(".xyz.npy")]
    assert files and _files(outs["cuda"]) == _files(outs["cpu"])
    for f in files:
        np.testing.assert_allclose(np.load(os.path.join(outs["cuda"], f)),
                                   np.load(os.path.join(outs["cpu"], f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)
