"""Port parity: losses, training metrics, the learning-rate schedule and
the train-step helpers against the JAX package.

Losses and metrics on the same numpy-seeded predictions and targets match
at rtol 1e-5 (NaN where a denominator is empty, in both); the learning rate
matches ``optax.piecewise_constant_schedule`` at rtol 1e-6 at every step
around the boundaries; the eval step of a bridged model matches the JAX
eval forward's losses and metrics at rtol 1e-4.
"""

import argparse

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models import losses as TL
from points2surf_tpu_torch.models.p2s import PointsToSurfModel as TorchP2S
from points2surf_tpu_torch.models.weights import state_dict_from_flax
from points2surf_tpu_torch.train import trainer as tt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.models import losses as JL  # noqa: E402

MAG_SIGN = ("imp_surf_magnitude", "imp_surf_sign")


def _batch(rng, b=64):
    gt = (rng.randn(b) * 0.05).astype(np.float32)
    return {
        "imp_surf_ms": gt,
        "imp_surf_magnitude_ms": np.abs(gt),
        "imp_surf_dist_sign_ms": (gt >= 0).astype(np.float32),
        "patch_radius_ms": (rng.rand(b) * 0.1 + 0.01).astype(np.float32),
    }


def _both(batch):
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("outputs", [MAG_SIGN, ("imp_surf",)])
@pytest.mark.parametrize("fixed_radius", [False, True])
def test_losses_and_metrics_match_jax(rng, outputs, fixed_radius):
    batch = _batch(rng)
    pred = (rng.randn(64, len(outputs)) * 2.0).astype(np.float32)
    tb, jb = _both(batch)
    weights = {o: 0.5 + i for i, o in enumerate(outputs)}
    got = TL.compute_loss(torch.from_numpy(pred), tb, outputs, weights,
                          fixed_radius)
    want = JL.compute_loss(jnp.asarray(pred), jb, outputs, weights,
                           fixed_radius)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    got_m = TL.calc_metrics(outputs, torch.from_numpy(pred), tb)
    want_m = JL.calc_metrics(outputs, jnp.asarray(pred), jb)
    assert set(got_m) == set(want_m)
    for k in got_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)


def test_metrics_nan_on_empty(rng):
    """No positive prediction: precision (and f1) are NaN in both."""
    tb, jb = _both(_batch(rng, 16))
    pred = -np.abs(rng.randn(16, 2)).astype(np.float32)
    got = TL.calc_metrics(MAG_SIGN, torch.from_numpy(pred), tb)
    want = JL.calc_metrics(MAG_SIGN, jnp.asarray(pred), jb)
    for k in ("precision", "f1_score"):
        assert np.isnan(got[k].item()) and np.isnan(float(want[k])), k
    np.testing.assert_allclose(got["recall"].item(), float(want["recall"]))
    assert TL.calc_metrics(("p_index",), torch.from_numpy(pred), tb) == {}


def test_sign_loss_is_stable_for_large_logits():
    pred = torch.tensor([-200.0, 200.0, 0.0])
    target = torch.tensor([1.0, 0.0, 1.0])
    got = TL.calc_loss_sign(pred, target)
    want = JL.calc_loss_sign(jnp.asarray(pred.numpy()),
                             jnp.asarray(target.numpy()))
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_learning_rate_matches_optax():
    optax = pytest.importorskip("optax")
    sched = optax.piecewise_constant_schedule(0.01, {3: 0.1, 7: 0.1})
    for step in range(12):
        np.testing.assert_allclose(tt.learning_rate(step, 0.01, (3, 7)),
                                   float(sched(step)), rtol=1e-6)


def _opt(**kw):
    base = dict(net_size=64, use_point_stn=1, use_feat_stn=1, sym_op="max",
                single_transformer=0, shared_transformer=1,
                train_dtype="float32")
    base.update(kw)
    return argparse.Namespace(**base)


def test_output_spec_and_build_model_match_jax():
    from points2surf_tpu.train import trainer as jt

    for outputs in (MAG_SIGN, ("imp_surf", "patch_pts_ids")):
        assert tt.output_spec(outputs) == jt.output_spec(outputs)
    with pytest.raises(ValueError):
        tt.output_spec(("p_index",))
    model = tt.build_model(_opt(), 2)
    jm = jt.build_model(_opt(), 2)
    dummy = {"patch_pts_ps": jnp.zeros((2, 8, 3)),
             "pts_sub_sample_ms": jnp.zeros((2, 8, 3)),
             "imp_surf_query_point_ms": jnp.zeros((2, 3))}
    params = jm.init(jax.random.key(0), dummy, True)["params"]
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(p).size for p in jax.tree.leaves(params))
    with pytest.raises(NotImplementedError):
        tt.build_model(_opt(train_dtype="bfloat16"), 2)


def test_eval_step_matches_jax(rng):
    from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S

    b = 8
    inputs = {
        "patch_pts_ps": (rng.randn(b, 30, 3) * 0.3).astype(np.float32),
        "pts_sub_sample_ms": (rng.randn(b, 50, 3) * 0.3).astype(np.float32),
        "imp_surf_query_point_ms": (rng.randn(b, 3) * 0.1).astype(
            np.float32),
    }
    inputs.update(_batch(rng, b))
    tb, jb = _both(inputs)
    m = JaxP2S(net_size_max=64, output_dim=2, shared_transformation=True)
    v = m.init(jax.random.key(0), jb, True)
    _, mut = m.apply(v, jb, True, mutable=["batch_stats"])
    variables = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    pred = m.apply(variables, jb, False)
    want = JL.compute_loss(pred, jb, MAG_SIGN, {o: 1.0 for o in MAG_SIGN},
                           False)
    want_m = JL.calc_metrics(MAG_SIGN, pred, jb)

    model = TorchP2S(net_size_max=64, output_dim=2,
                     shared_transformation=True)
    model.load_state_dict(state_dict_from_flax(
        *jax.tree.map(np.asarray, (variables["params"],
                                   variables["batch_stats"]))))
    steps = tt.make_train_step(model, MAG_SIGN)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, metrics = steps.eval_step(tb)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want), rtol=1e-4)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    assert model.training  # restored
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k  # no running-statistic update
