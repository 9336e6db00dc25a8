"""Port parity: one fused train step against the JAX package.

The JAX step is built as ``bench.py`` builds its train step: train-mode
``extract_patches``, ``jax.value_and_grad`` of ``compute_loss`` through
``model.apply(..., True, mutable=["batch_stats"])``, then ``optax.sgd(lr,
momentum=0.9)``. The port runs ``TrainStep.train_step_fused`` on the same
numpy-seeded cloud, queries and ground truth, with the JAX parameters
bridged by ``state_dict_from_flax`` and JAX's random draws (sub-sample and
rotations) injected. On the CPU the port's kernels take their plain
versions and JAX takes its XLA tail.

Tolerances: losses and metrics rtol 1e-4; every gradient rtol 1e-3 with
atol 1e-3 * max|g| of its tensor, except gradients that vanish in exact
arithmetic (a bias right before a batch-statistics BatchNorm), which are
rounding noise in both packages and are held to |g| < 1e-6 * max|g| of the
whole model; updated parameters and running statistics rtol 1e-4 with
atol 1e-6 (running means start at 0, so the absolute floor covers channels
whose batch mean is near 0).

The last layer of every spatial transformer starts at zero (their output
is then exactly the identity, as STNs are commonly initialized). At a
random init in float32 each transformer multiplies the rounding
differences between the two packages about tenfold, enough to flip
near-tied arg decisions of the max pools, and each flip routes one row's
gradient elsewhere (a few percent on the upstream gradients). Gradients
still flow through every transformer, and the second step of the momentum
test runs with non-zero transformer outputs.
"""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.p2s import PointsToSurfModel as TorchP2S
from points2surf_tpu_torch.models.weights import (
    sgd_state_from_checkpoint,
    state_dict_from_flax,
)
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.train.trainer import make_train_step

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.models import losses as JL  # noqa: E402
from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S  # noqa: E402
from points2surf_tpu.ops import patches as jp  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
NET = 64
B = 8
N = 4096
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
WEIGHTS = {o: 1.0 for o in OUTPUTS}
KW = dict(points_per_patch=32, sub_sample_size=64, subsample_candidates=4)
VARIANTS = {
    "vanilla": {},
    "shared": {"shared_transformation": True},
    "single": {"single_transformer": True},
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    cloud = np.load(CLOUD)[:, :3].astype(np.float32)
    pts = cloud[rng.choice(len(cloud), N, replace=False)]
    q = pts[rng.choice(N, B, replace=False)] + rng.randn(B, 3).astype(
        np.float32) * 0.01
    gt = (rng.randn(B) * 0.05).astype(np.float32)
    return pts, q.astype(np.float32), gt


def _jax_step(model, tx):
    cfg = jp.PatchConfig(**KW)

    def loss_fn(p, bs, bt):
        pred, mutated = model.apply({"params": p, "batch_stats": bs}, bt,
                                    True, mutable=["batch_stats"])
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


def _jax_init(variant, sym_op):
    m = JaxP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
               **VARIANTS[variant])
    dummy = {"patch_pts_ps": jnp.zeros((2, KW["points_per_patch"], 3)),
             "pts_sub_sample_ms": jnp.zeros((2, KW["sub_sample_size"], 3)),
             "imp_surf_query_point_ms": jnp.zeros((2, 3))}
    v = m.init(jax.random.key(0), dummy, True)
    return m, _identity_transformers(v["params"]), v["batch_stats"]


def _identity_transformers(tree):
    """Zero the last layer of every spatial transformer (their output is
    then exactly the identity rotation in both packages)."""
    out = {}
    for key, val in tree.items():
        if key == "trunk":
            val = dict(val)
            val["fc3"] = jax.tree.map(jnp.zeros_like, val["fc3"])
        out[key] = _identity_transformers(val) if isinstance(val, dict) else val
    return out


def _port(variant, sym_op, params, stats, **step_kw):
    model = TorchP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
                     **VARIANTS[variant])
    np_tree = jax.tree.map(np.asarray, (params, stats))
    model.load_state_dict(state_dict_from_flax(*np_tree), strict=True)
    return make_train_step(model, OUTPUTS, patch_cfg=tp.PatchConfig(**KW),
                           **step_kw)


def _port_step(steps, key, pts, q, gt):
    from test_torch_patches import jax_train_draws

    draws = jax_train_draws(key, B, N, steps.patch_cfg)
    return steps.train_step_fused(torch.from_numpy(pts), torch.from_numpy(q),
                                  N, torch.from_numpy(gt), draws)


def _assert_state(model, params, stats):
    """Parameters and running statistics of ``model`` against JAX's."""
    want = state_dict_from_flax(*jax.tree.map(np.asarray, (params, stats)))
    got = model.state_dict()
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def _assert_losses_metrics(losses, metrics, j_ll, j_metrics):
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_ll), rtol=1e-4)
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(j_metrics[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("variant,sym_op", [
    ("vanilla", "max"), ("shared", "max"), ("single", "max"),
    ("shared", "sum")])
def test_fused_train_step_matches_jax(variant, sym_op):
    pts, q, gt = _data()
    m, params, stats = _jax_init(variant, sym_op)
    tx = optax.sgd(0.01, momentum=0.9)
    key = jax.random.key(11)
    new_p, new_bs, _, j_ll, j_metrics, grads = _jax_step(m, tx)(
        params, stats, tx.init(params), jnp.asarray(pts), jnp.asarray(q),
        jnp.asarray(gt), key)

    steps = _port(variant, sym_op, params, stats, lr=0.01, momentum=0.9)
    losses, metrics = _port_step(steps, key, pts, q, gt)

    _assert_losses_metrics(losses, metrics, j_ll, j_metrics)
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(steps.model.named_parameters())
    assert set(named) == {k for k in want_g
                          if not k.endswith("num_batches_tracked")}
    g_max = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in named.items():
        g = want_g[name].numpy()
        if np.abs(g).max() < 1e-6 * g_max:  # zero in exact arithmetic
            assert float(p.grad.abs().max()) < 1e-6 * g_max, name
            continue
        atol = 1e-3 * float(np.abs(g).max())
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3, atol=atol,
                                   err_msg=name)
    _assert_state(steps.model, new_p, new_bs)


def test_momentum_carry_matches_jax(tmp_path):
    """JAX takes two steps under a schedule with a boundary at step 1; the
    port starts from JAX's state after the first step (parameters, running
    statistics, and the momentum trace and step count as the JAX package's
    checkpoint stores them) and takes the second."""
    from points2surf_tpu.train.checkpoint import save_state

    pts, q, gt = _data(1)
    m, params, stats = _jax_init("shared", "max")
    tx = optax.sgd(optax.piecewise_constant_schedule(0.01, {1: 0.1}),
                   momentum=0.9)
    step = _jax_step(m, tx)
    args = (jnp.asarray(pts), jnp.asarray(q), jnp.asarray(gt))
    p1, bs1, opt1, *_ = step(params, stats, tx.init(params), *args,
                             jax.random.key(1))
    p2, bs2, _, j_ll, j_metrics, _ = step(p1, bs1, opt1, *args,
                                          jax.random.key(2))

    path = str(tmp_path / "state.npz")
    save_state(path, {"params": p1, "batch_stats": bs1, "opt_state": opt1})
    with np.load(path) as flat:
        buffers, count = sgd_state_from_checkpoint(dict(flat))
    assert count == 1
    steps = _port("shared", "max", p1, bs1, lr=0.01, momentum=0.9,
                  boundaries=(1,))
    steps.load_sgd_state(buffers, count)
    losses, metrics = _port_step(steps, jax.random.key(2), pts, q, gt)
    _assert_losses_metrics(losses, metrics, j_ll, j_metrics)
    _assert_state(steps.model, p2, bs2)
    assert steps.step == 2
