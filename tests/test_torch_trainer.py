"""Port parity: the epoch loop (``train/trainer.Trainer``) against the JAX
package's ``Trainer``, at ``tests/test_trainer.py``'s small size.

Both trainers ``--refine`` from the same JAX-written fresh state (start
epoch 0, zero momentum) and train 2 epochs on the bundled dataset, with
JAX's random draws injected into the port's pipelines (fused train steps,
mixed batches, interleaved test batches). JAX runs its train tail as its
CPU tests do (fp32 Pallas interpret). Tolerances: every logged loss (and
the distance RMS) rtol 1e-3, the logged learning rates exactly, the final
parameters and batch statistics rtol 1e-3 / atol 1e-5, and the same
checkpoint and snapshot file names.

``cuda``-marked: one epoch on the card against the same epoch on the CPU,
with the same injected draws, the kernels launched.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.weights import flax_from_state_dict
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.train.trainer import Trainer as TorchTrainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
LOGGED_EXACT = ("LR",)


class RecordingWriter:
    """TensorBoard writer stand-in: keeps (tag, value, step)."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), float(step)))

    def flush(self):
        pass


def train_opt(tmp, **kw):
    """``tests/test_trainer.py``'s small training options: net 32, 16 patch
    points, 32 sub-sample points, 48 patches per shape, batch 32."""
    d = dict(
        name="t", desc="t", indir=ABC,
        outdir=os.path.join(tmp, "models"),
        logdir=os.path.join(tmp, "logs"),
        trainset="trainset.txt", testset="valset.txt",
        save_interval=1, debug_interval=100, refine="",
        patch_radius=0.0, net_size=32, nepoch=1, batchSize=32,
        patch_center="mean", patch_point_count_std=0,
        patches_per_shape=48, sub_sample_size=32, workers=0,
        cache_capacity=4, seed=11, single_transformer=0,
        uniform_subsample=0, fixed_subsample=0, shared_transformer=0,
        training_order="random_shape_consecutive", identical_epochs=0,
        lr=0.01, scheduler_steps=[2, 4], momentum=0.9,
        normal_loss="ms_euclidean",
        outputs=["imp_surf_magnitude", "imp_surf_sign", "patch_pts_ids",
                 "p_index"],
        use_point_stn=0, use_feat_stn=0, sym_op="max",
        points_per_patch=16, debug=0,
    )
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.fixture
def jax_cpu_kernels(monkeypatch):
    """The JAX train tail as its CPU tests run it: fp32 Pallas interpret;
    exact eval selection. The port runs on one CPU thread, where its
    matmuls sum in an order that lands on XLA's side of a near-tie: at the
    second step one ReLU input of the global branch's conv2 (the row of 12
    pooled channels of its conv3 tail) is 7e-7 on one thread and -1.3e-6
    on eight, so eight threads cut those channels' gradients there, and
    the runs part (the sixth step's magnitude loss 2.4e-3 apart)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX package's models need it
    monkeypatch.setenv("P2S_PALLAS_TAIL_PREC", "highest")
    monkeypatch.setenv("P2S_PALLAS_TAIL_INTERPRET", "1")
    monkeypatch.setenv("P2S_EVAL_APPROX_SELECT", "0")
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield jax
    torch.set_num_threads(threads)
    for k in ("P2S_PALLAS_TAIL_PREC", "P2S_PALLAS_TAIL_INTERPRET",
              "P2S_EVAL_APPROX_SELECT"):
        monkeypatch.delenv(k)
    jax.clear_caches()


def _assert_logs(got, want):
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    for (tag, g, _), (_, w, _) in zip(got, want):
        if tag in LOGGED_EXACT:
            assert g == w, tag
        elif tag.startswith("loss/") or tag.endswith("abs_dist_rms"):
            np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=tag)


def test_trainer_matches_jax(tmp_path, monkeypatch, jax_cpu_kernels):
    jax = jax_cpu_kernels
    from test_torch_data import inject_jax_draws

    from points2surf_tpu.train import checkpoint as jckpt
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer

    fresh = str(tmp_path / "fresh" / "t_model.npz")
    jckpt.save_state(fresh, JaxTrainer(train_opt(str(tmp_path / "init")))
                     .state_dict())
    kw = dict(nepoch=2, refine=fresh)

    jw = RecordingWriter()
    jt = JaxTrainer(train_opt(str(tmp_path / "jax"), **kw), log_writer=jw)
    jt.train()

    tw = RecordingWriter()
    tt = TorchTrainer(train_opt(str(tmp_path / "port"), **kw), log_writer=tw,
                      device="cpu")
    assert tt.start_epoch == 0 and tt.steps.step == 0
    inject_jax_draws(monkeypatch, tt.train_pipe, fused_batch=32)
    inject_jax_draws(monkeypatch, tt.test_pipe)
    tt.train()

    tags = {t for t, _, _ in tw.scalars}
    assert {"loss/train/total", "loss/eval/total", "LR"} <= tags
    _assert_logs(tw.scalars, jw.scalars)
    assert tt.global_step == jt.global_step == 6
    assert tt.steps.step == 6

    params, stats = flax_from_state_dict(tt.model.state_dict())
    want = jax.tree_util.tree_leaves((jt.params, jt.batch_stats))
    got = jax.tree_util.tree_leaves((params, stats))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-5)
    assert (sorted(os.listdir(tmp_path / "port" / "models"))
            == sorted(os.listdir(tmp_path / "jax" / "models"))
            == ["t_description.txt", "t_model.npz", "t_model_0.npz",
                "t_model_1.npz", "t_params.json"])


def test_resume_from_snapshot(tmp_path, monkeypatch):
    """A resume from the epoch-1 snapshot starts at epoch 2 with the
    momentum and step count of the run that wrote it. The first run also
    logs every batch (--log_every_batch) and writes the profiler trace."""
    monkeypatch.setenv("P2S_PROFILE_DIR", str(tmp_path / "trace"))
    w = RecordingWriter()
    tr = TorchTrainer(train_opt(str(tmp_path), nepoch=2, log_every_batch=1),
                      log_writer=w, device="cpu")
    tr.train()  # global steps 0-5: the trace starts at step 5
    assert sum(t == "loss/train/total" for t, _, _ in w.scalars) == 6
    assert os.listdir(tmp_path / "trace") == ["train_steps_5_10.json"]
    monkeypatch.delenv("P2S_PROFILE_DIR")
    snap = str(tmp_path / "models" / "t_model_1.npz")
    tr2 = TorchTrainer(train_opt(str(tmp_path), nepoch=4, refine=snap),
                       device="cpu")
    assert tr2.start_epoch == 2 and tr2.global_step == 6
    assert tr2.steps.step == 6
    state = tr2.steps.optimizer.state
    assert all(float(state[p]["momentum_buffer"].abs().max()) > 0
               for p in tr2.model.parameters() if p.dim() > 1)
    tr2.train()  # epochs 2 and 3
    assert tr2.steps.step == 12


def test_bfloat16_raises(tmp_path):
    """train_dtype=bfloat16, which raised before it was ported, builds the
    bf16-activation model (float32 parameters, bf16 predictions) and trains
    an epoch; f32_finetune_epochs 0 keeps bf16 to the end, and the
    checkpoint is float32."""
    tr = TorchTrainer(train_opt(str(tmp_path), train_dtype="bfloat16",
                                f32_finetune_epochs=0), device="cpu")
    assert tr.model.act_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    tr.train()
    assert tr.model.act_dtype == torch.bfloat16 and tr.global_step == 3
    with np.load(tmp_path / "models" / "t_model.npz") as flat:
        assert {flat[k].dtype for k in flat.files} <= {np.dtype(np.float32),
                                                       np.dtype(np.int32)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cpu_draws(monkeypatch, pipe, seed):
    """Draws made on a CPU generator and moved to the pipe's device, so a
    GPU and a CPU run see the same numbers."""
    gen = torch.Generator().manual_seed(seed)

    def draws(b, n, small_cloud=False, n_valid=None):
        d = tp.draw_batch(gen, b, n, pipe.cfg, small_cloud, train=True,
                          n_valid=n_valid)
        return d.to(pipe.store.device)

    monkeypatch.setattr(pipe, "draws", draws)


@pytest.mark.cuda
def test_trainer_on_cuda_matches_cpu(tmp_path, monkeypatch, cuda_device):
    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        w = RecordingWriter()
        tr = TorchTrainer(train_opt(str(tmp_path / dev.type)), log_writer=w,
                          device=dev)
        _cpu_draws(monkeypatch, tr.train_pipe, 1)
        _cpu_draws(monkeypatch, tr.test_pipe, 2)
        pooled_tail_reductions.launches = chain_pool.launches = 0
        tr.train()
        runs[dev.type] = (w.scalars, pooled_tail_reductions.launches,
                          chain_pool.launches, tr.model.state_dict())
    g, c = runs["cuda"], runs["cpu"]
    assert g[1] > 0 and g[2] > 0  # the train tails and the test batches
    assert c[1] == c[2] == 0
    assert [(t, s) for t, _, s in g[0]] == [(t, s) for t, _, s in c[0]]
    for (tag, gv, _), (_, cv, _) in zip(g[0], c[0]):
        if tag.startswith("loss/"):
            np.testing.assert_allclose(gv, cv, rtol=1e-3, atol=1e-4,
                                       err_msg=tag)
    for k, v in c[3].items():
        if v.is_floating_point():
            np.testing.assert_allclose(g[3][k].cpu().numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=k)
