"""Port parity: bfloat16 activations (``dtype=torch.bfloat16``, the JAX
package's ``--train_dtype`` / ``--eval_dtype bfloat16``) against the JAX
package on the CPU, and precision annealing.

bf16 keeps 8 significant bits, a unit round-off of u = 2^-8 relative. Both
packages round each linear layer's product and bias sum and each BatchNorm
output to bf16 and keep the statistics in fp32, so most values agree bit for
bit; where two summation orders of one fp32 accumulation straddle a bf16
rounding boundary, a value moves by one bf16 ulp (2u of it), and that
propagates. Tolerances, each above what these tests measured:

* eval forward: atol u * max|ref| (measured: bit-identical);
* train-mode layers on the same inputs (the encoder without transformers,
  the train tail and its VJP): the encoder's output within one bf16 ulp
  (2u * max|ref|; measured: a fifth of the elements one ulp apart, where
  the two packages' fp32 batch statistics round apart, the rest equal), the
  running statistics (means of those bf16 values) within u of their
  largest (measured 2.3e-4 of it), the tail's fp32 sums and backward at rtol 1e-5
  / 1e-4;
* one whole train step (identity transformers, as
  ``tests/test_torch_train.py``): a train-mode BatchNorm over a batch of 8
  divides by the batch spread, so one bf16 ulp that two reduction orders
  round apart upstream grows there, and a max pool's arg then moves to
  another of the many exact bf16 ties: the step is as far from JAX's bf16
  step as JAX's bf16 step is from its fp32 one (measured: prediction 3% of
  max|pred| apart, losses up to 5.4%, gradient cosine 0.92-0.98 against JAX
  bf16-vs-fp32's 0.94-0.997). Held: losses and the distance RMS rtol 32u;
  the gradients' cosine > 0.85 (all but the biases right before a
  batch-statistics BatchNorm); updated parameters within 2 lr max|g|.

No kernel launches in bf16 (``cuda``-marked: on the card the launch
counters stay at 0 through a bf16 forward and train step).
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.p2s import PointsToSurfModel as TorchP2S
from points2surf_tpu_torch.models.weights import state_dict_from_flax
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.train import trainer as tt

U = 2.0 ** -8  # bf16 unit round-off
NET = 64
BF16 = torch.bfloat16
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
VARIANTS = {
    "vanilla": {},
    "shared": {"shared_transformation": True},
    "single": {"single_transformer": True},
}


@pytest.fixture
def jx(monkeypatch):
    """The JAX package's pieces (the test skips without jax); this module
    imports no jax, so its ``cuda`` test runs where jax is missing."""
    import types

    ns = types.SimpleNamespace(
        jax=pytest.importorskip("jax"), jnp=pytest.importorskip("jax.numpy"),
        optax=pytest.importorskip("optax"), flax=pytest.importorskip("flax"))
    from points2surf_tpu.models import losses as JL
    from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S
    from points2surf_tpu.ops import patches as jp

    ns.JL, ns.JaxP2S, ns.jp = JL, JaxP2S, jp
    return ns


def _batch(rng, b=8):
    return {
        "patch_pts_ps": (rng.randn(b, 30, 3) * 0.3).astype(np.float32),
        "pts_sub_sample_ms": (rng.randn(b, 50, 3) * 0.3).astype(np.float32),
        "imp_surf_query_point_ms": (rng.randn(b, 3) * 0.1).astype(np.float32),
    }


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_bf16_eval_forward_matches_jax(rng, jx, variant, sym_op):
    jax, jnp = jx.jax, jx.jnp
    m = jx.JaxP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
               dtype=jnp.bfloat16, **VARIANTS[variant])
    batch = _batch(rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = m.init(jax.random.key(0), jb, True)
    _, mut = m.apply(v, jb, True, mutable=["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, mut["batch_stats"])
    want = m.apply({"params": params, "batch_stats": stats}, jb, False)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    model = TorchP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
                     dtype=BF16, **VARIANTS[variant])
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(x) for k, x in batch.items()})
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=U * np.abs(want).max())
    # the float32 model on the same weights is another function
    model32 = TorchP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
                       **VARIANTS[variant])
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        f32 = model32.eval()({k: torch.from_numpy(x)
                              for k, x in batch.items()}).numpy()
    assert np.abs(f32 - want).max() > 0


def _jax_bf16_step(jx, model, tx):
    """The JAX Trainer's fused step (``train/trainer.py``): the prediction
    cast to float32 before the losses and metrics."""
    from test_torch_train import KW, N, WEIGHTS

    jax, jnp, optax, JL, jp = jx.jax, jx.jnp, jx.optax, jx.JL, jx.jp
    cfg = jp.PatchConfig(**KW)

    def loss_fn(p, bs, bt):
        pred, mutated = model.apply({"params": p, "batch_stats": bs}, bt,
                                    True, mutable=["batch_stats"])
        pred = pred.astype(jnp.float32)
        ll = JL.compute_loss(pred, bt, OUTPUTS, WEIGHTS, fixed_radius=False)
        return sum(ll), (jnp.stack(ll), pred, mutated["batch_stats"])

    @jax.jit
    def step(p, bs, opt, pts, q, gt, key):
        bt = jp.extract_patches(pts, q, jnp.int32(N), key, cfg=cfg,
                                train=True)
        bt["imp_surf_ms"] = gt
        bt["imp_surf_magnitude_ms"] = jnp.abs(gt)
        bt["imp_surf_dist_sign_ms"] = (gt >= 0.0).astype(jnp.float32)
        (_, (ll, pred, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, bs, bt)
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, updates)
        return p, new_bs, opt, ll, JL.calc_metrics(OUTPUTS, pred, bt), grads

    return step


@pytest.mark.parametrize("variant,sym_op", [
    ("vanilla", "max"), ("shared", "max"), ("single", "max"),
    ("shared", "sum")])
def test_bf16_train_step_matches_jax(jx, variant, sym_op):
    from test_torch_patches import jax_train_draws
    from test_torch_train import B, KW, N, _data, _identity_transformers

    jax, jnp = jx.jax, jx.jnp
    pts, q, gt = _data()
    m = jx.JaxP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
               dtype=jnp.bfloat16, **VARIANTS[variant])
    dummy = {"patch_pts_ps": jnp.zeros((2, KW["points_per_patch"], 3)),
             "pts_sub_sample_ms": jnp.zeros((2, KW["sub_sample_size"], 3)),
             "imp_surf_query_point_ms": jnp.zeros((2, 3))}
    v = m.init(jax.random.key(0), dummy, True)
    params, stats = _identity_transformers(v["params"]), v["batch_stats"]
    lr = 0.01
    tx = jx.optax.sgd(lr, momentum=0.9)
    key = jax.random.key(11)
    new_p, new_bs, _, j_ll, j_metrics, grads = _jax_bf16_step(jx, m, tx)(
        params, stats, tx.init(params), jnp.asarray(pts), jnp.asarray(q),
        jnp.asarray(gt), key)

    model = TorchP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
                     dtype=BF16, **VARIANTS[variant])
    model.load_state_dict(state_dict_from_flax(
        *jax.tree.map(np.asarray, (params, stats))), strict=True)
    steps = tt.make_train_step(model, OUTPUTS, lr=lr, momentum=0.9,
                               patch_cfg=tp.PatchConfig(**KW))
    draws = jax_train_draws(key, B, N, steps.patch_cfg)
    losses, metrics = steps.train_step_fused(
        torch.from_numpy(pts), torch.from_numpy(q), N, torch.from_numpy(gt),
        draws)
    assert losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_ll), rtol=32 * U)
    np.testing.assert_allclose(metrics["abs_dist_rms"].item(),
                               float(j_metrics["abs_dist_rms"]), rtol=32 * U)
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(model.named_parameters())
    for p in named.values():
        assert p.dtype == p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all())
    # every gradient but those of the biases right before a batch-statistics
    # BatchNorm (zero in exact arithmetic, rounding noise in both)
    names = [k for k in named if not (k.endswith(".bias") and k.split(".")[
        -2].startswith(("conv", "fc")) and not k.startswith("fc4"))]
    got = np.concatenate([named[k].grad.numpy().ravel() for k in names])
    ref = np.concatenate([want_g[k].numpy().ravel() for k in names])
    cos = float(got @ ref / np.linalg.norm(got) / np.linalg.norm(ref))
    assert cos > 0.85, cos
    g_max = float(np.abs(ref).max())
    want = state_dict_from_flax(*jax.tree.map(np.asarray, (new_p, new_bs)))
    for k, p in named.items():  # p - lr g, with a gradient within 2 max|g|
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=2 * lr * g_max + 1e-7,
                                   err_msg=k)


def test_bf16_train_layers_match_jax(rng, jx):
    """Layer by layer, on the same inputs: the encoder without transformers
    in train mode (bf16 linear layers, fp32-statistics BatchNorms, the bf16
    train tail) gives JAX's output within one bf16 ulp and its running
    statistics; the train tail's reductions and their VJP on the
    same cotangents give JAX's (first-index args of the bf16 products, the
    backward in fp32: rtol 1e-4)."""
    from points2surf_tpu.models import pointnet as jpn
    from points2surf_tpu_torch.models import pointnet as tpn

    jax, jnp = jx.jax, jx.jnp
    x = (rng.randn(16, 64, 3) * 0.3).astype(np.float32)
    for sym_op in ("max", "sum"):
        kw = dict(net_size_max=NET, output_size=NET, use_point_stn=False,
                  use_feat_stn=False, sym_op=sym_op)
        jm = jpn.PointNetFeat(dtype=jnp.bfloat16, **kw)
        v = jm.init(jax.random.key(0), jnp.asarray(x), True)
        (want, *_), mut = jm.apply(v, jnp.asarray(x), True,
                                   mutable=["batch_stats"])
        model = tpn.PointNetFeat(dtype=BF16, **kw)
        model.load_state_dict(state_dict_from_flax(
            *jax.tree.map(np.asarray, (v["params"], v["batch_stats"]))))
        got = model(torch.from_numpy(x))[0].float().detach().numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * U * np.abs(want).max())
        stats = state_dict_from_flax(v["params"], jax.tree.map(
            np.asarray, mut["batch_stats"]))
        for k, val in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                ref = stats[k].numpy()
                np.testing.assert_allclose(val.numpy(), ref, rtol=1e-5,
                                           atol=U * np.abs(ref).max(),
                                           err_msg=k)

    # the train tail alone: post-relu bf16 activations, many exact ties
    h = np.maximum(rng.randn(8, 40, 128), 0).astype(np.float32)
    h = np.array(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))
    w = (rng.randn(128, 96) / 11.0).astype(np.float32)
    b = (rng.randn(96) * 0.1).astype(np.float32)
    for need_minmax in (True, False):
        def f(hh, ww, bb):
            out = jpn._linear_pool_reductions(hh, ww, bb, jnp.bfloat16,
                                              need_minmax, True)
            return tuple(o for o in out if o is not None)

        hb = jnp.asarray(h).astype(jnp.bfloat16)
        want, vjp = jax.vjp(f, hb, jnp.asarray(w), jnp.asarray(b))
        cot = tuple(jnp.asarray(rng.randn(*o.shape).astype(np.float32))
                    .astype(o.dtype) for o in want)
        want_g = vjp(cot)
        ht = torch.from_numpy(h).to(BF16).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        got = tpn._LinearPoolReductions.apply(ht, wt, bt, need_minmax, BF16)
        assert len(got) == len(want)
        for g, r in zip(got, want):
            assert g.dtype == (BF16 if r.dtype == jnp.bfloat16
                               else torch.float32)
            np.testing.assert_allclose(
                g.float().detach().numpy(),
                np.asarray(r.astype(jnp.float32)), rtol=1e-5, atol=1e-6)
        torch.autograd.backward(got, [torch.from_numpy(np.array(
            c.astype(jnp.float32))).to(g.dtype) for c, g in zip(cot, got)])
        for g, r in ((ht.grad, want_g[0]), (wt.grad, want_g[1]),
                     (bt.grad, want_g[2])):
            r = np.asarray(r.astype(jnp.float32))
            np.testing.assert_allclose(g.float().numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max())


def test_f32_switch_epoch():
    """The JAX Trainer's rule: nepoch - f32_finetune_epochs, with -1 for
    max(5, nepoch // 5)."""
    from argparse import Namespace

    for nepoch, tail, want in ((2, -1, -3), (10, -1, 5), (40, -1, 32),
                               (150, -1, 120), (10, 3, 7), (10, 0, 10)):
        opt = Namespace(nepoch=nepoch, f32_finetune_epochs=tail)
        assert tt.f32_switch_epoch(opt) == want
    assert tt.f32_switch_epoch(Namespace(nepoch=4)) == 4  # the option unset


def test_precision_annealing(tmp_path, capsys):
    """bf16 steps until the switch epoch, float32 steps from it on, on the
    same float32 parameters and SGD state; the switch is announced as the
    JAX Trainer announces it."""
    from test_torch_trainer import train_opt

    tr = tt.Trainer(train_opt(str(tmp_path), nepoch=3, train_dtype="bfloat16",
                              f32_finetune_epochs=1), device="cpu")
    seen = []
    step = tr.steps.train_step

    def recording(batch):
        seen.append(tr.model.act_dtype)
        out = step(batch)
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
        return out

    tr.steps.train_step = recording
    opt_state = tr.steps.optimizer
    tr.train()
    assert seen == [BF16] * 6 + [None] * 3  # 3 steps per epoch
    assert tr.steps.optimizer is opt_state and tr.steps.step == 9
    assert tr.model.act_dtype is None
    out = capsys.readouterr().out
    assert "precision annealing: switching to float32 steps at epoch 2" in out
    # float32 training never switches
    tr32 = tt.Trainer(train_opt(str(tmp_path / "f32"), nepoch=1),
                      device="cpu")
    assert tr32.model.act_dtype is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_launches_no_kernel(cuda_device):
    """A bf16 forward (eval) and train step on the card launch no kernel in
    either operand mode, as the JAX package's gates route bf16; the same
    float32 model launches them."""
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)

    kernels = (chain_head, chain_pool, pooled_tail_reductions)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in _batch(rng, 16).items()}
    gt = torch.from_numpy((rng.randn(16) * 0.05).astype(np.float32)).to(
        cuda_device)
    batch.update(imp_surf_ms=gt, imp_surf_magnitude_ms=gt.abs(),
                 imp_surf_dist_sign_ms=(gt >= 0).float(),
                 patch_radius_ms=torch.full_like(gt, 0.1))
    counts = {}
    for dtype in (BF16, None):
        model = TorchP2S(net_size_max=128, output_dim=2, dtype=dtype,
                         shared_transformation=True).to(cuda_device)
        for f in kernels:
            f.launches = f.launches_bf16 = 0
        steps = tt.make_train_step(model, OUTPUTS)
        losses, _ = steps.train_step(batch)
        with torch.inference_mode():
            pred = model.eval()(batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(losses).all())
        assert bool(torch.isfinite(pred.float()).all())
        counts[dtype] = sum(f.launches + f.launches_bf16 for f in kernels)
    assert counts[BF16] == 0 and counts[None] == 5 + 5 + 5
