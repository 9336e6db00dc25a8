"""Port parity: the eval forward of PointsToSurfModel with bridged weights.

The JAX model is initialized and run once in train mode so that its
batch_stats are non-trivial; its parameters go through
``state_dict_from_flax`` into the torch model (``strict=True``). The torch
eval forward must match the JAX eval forward, both its literal layer stack
and its fused chain kernel (interpret mode, fp32 operands), at 1e-4.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.p2s import PointsToSurfModel as TorchP2S
from points2surf_tpu_torch.models.weights import state_dict_from_flax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.models.import_torch import export_state_dict  # noqa: E402
from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S  # noqa: E402

NET = 64
VARIANTS = {
    "vanilla": {},
    "shared": {"shared_transformation": True},
    "single": {"single_transformer": True},
}


def _batch(rng, b=8):
    return {
        "patch_pts_ps": (rng.randn(b, 30, 3) * 0.3).astype(np.float32),
        "pts_sub_sample_ms": (rng.randn(b, 50, 3) * 0.3).astype(np.float32),
        "imp_surf_query_point_ms": (rng.randn(b, 3) * 0.1).astype(np.float32),
    }


def _jax_model(rng, variant, sym_op):
    m = JaxP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
               **VARIANTS[variant])
    batch = {k: jnp.asarray(v) for k, v in _batch(rng).items()}
    v = m.init(jax.random.key(0), batch, True)
    _, mut = m.apply(v, batch, True, mutable=["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, mut["batch_stats"])
    return m, params, stats


def _torch_model(variant, sym_op, params, stats):
    model = TorchP2S(net_size_max=NET, output_dim=2, sym_op=sym_op,
                     **VARIANTS[variant])
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_eval_forward_matches_jax(rng, monkeypatch, variant, sym_op):
    m, params, stats = _jax_model(rng, variant, sym_op)
    model = _torch_model(variant, sym_op, params, stats)
    batch = _batch(rng)
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    got = got.numpy()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = {"params": params, "batch_stats": stats}

    monkeypatch.delenv("P2S_EVAL_CHAIN", raising=False)
    jax.clear_caches()
    literal = np.asarray(m.apply(variables, jb, False))
    np.testing.assert_allclose(got, literal, rtol=1e-4, atol=1e-4)

    monkeypatch.setenv("P2S_EVAL_CHAIN", "1")
    monkeypatch.setenv("P2S_EVAL_CHAIN_INTERPRET", "1")
    monkeypatch.setenv("P2S_EVAL_CHAIN_PREC", "highest")
    jax.clear_caches()  # the gates are read at trace time
    fused = np.asarray(m.apply(variables, jb, False))
    for name in ("P2S_EVAL_CHAIN", "P2S_EVAL_CHAIN_INTERPRET",
                 "P2S_EVAL_CHAIN_PREC"):
        monkeypatch.delenv(name)
    jax.clear_caches()
    np.testing.assert_allclose(got, fused, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_layout_matches_export(rng, variant):
    _, params, stats = _jax_model(rng, variant, "max")
    model = _torch_model(variant, "max", params, stats)
    exported = export_state_dict(params, stats)
    assert set(model.state_dict()) == set(exported)
    for key, val in model.state_dict().items():
        assert tuple(val.shape) == np.asarray(exported[key]).shape, key
    n_jax = sum(np.asarray(p).size for p in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_load_reference_pth_strips_data_parallel_prefix(rng, tmp_path):
    from points2surf_tpu_torch.models.weights import load_reference_pth

    _, params, stats = _jax_model(rng, "shared", "max")
    path = tmp_path / "model.pth"
    torch.save({"module." + k: v
                for k, v in state_dict_from_flax(params, stats).items()},
               path)
    model = load_reference_pth(
        TorchP2S(net_size_max=NET, shared_transformation=True), str(path))
    want = _torch_model("shared", "max", params, stats).state_dict()
    for key, val in model.state_dict().items():
        assert torch.equal(val, want[key]), key


def test_train_mode_and_multiscale_raise():
    """Train mode runs (batch statistics, running statistics updated, a
    gradient for every parameter), and so does the multi-scale branch,
    which raised before it was ported."""
    from points2surf_tpu_torch.models.pointnet import PointNetFeat

    model = TorchP2S(net_size_max=NET)  # modules start in train mode
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(np.random.RandomState(0), 4).items()}
    before = model.feat_local.bn1.running_var.clone()
    pred = model(batch)
    assert pred.shape == (4, 2) and bool(torch.isfinite(pred).all())
    assert not torch.equal(model.feat_local.bn1.running_var, before)
    pred.square().sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    feat = PointNetFeat(net_size_max=NET, output_size=32, num_scales=2)
    out = feat(torch.randn(4, 2 * 24, 3))[0]
    assert out.shape == (4, 32 * 2 ** 2)
    out.square().sum().backward()
    assert all(p.grad is not None for p in feat.parameters())


MS = dict(net_size_max=128, output_size=64, use_point_stn=True,
          use_feat_stn=True, num_scales=2)


@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_multiscale_feat_matches_jax(rng, tmp_path, sym_op):
    """PointNetFeat(num_scales=2), the reference's multi-scale encoder
    (per-scale pools, the STNs' fc0/bn0, the conv4/bn4 expansion): JAX's
    weights bridged into the port (and back, and through a reference
    ``.pth``), one train-mode forward (output and running statistics) and
    the eval forward after it, within 1e-4. The transformers' last layers
    start at zero, as in ``tests/test_torch_train.py``: at a random init a
    train-mode transformer amplifies the two packages' float32 rounding
    about tenfold each (7.6e-4 of 7.4 here with both)."""
    from test_torch_train import _identity_transformers

    from points2surf_tpu.models.pointnet import PointNetFeat as JaxFeat
    from points2surf_tpu_torch.models.pointnet import PointNetFeat
    from points2surf_tpu_torch.models.weights import (
        flax_from_state_dict, load_reference_pth)

    x = rng.randn(6, 2 * 24, 3).astype(np.float32) * 0.5
    jm = JaxFeat(sym_op=sym_op, **MS)
    v = jm.init(jax.random.key(2), jnp.asarray(x), True)
    params = jax.tree.map(np.asarray, _identity_transformers(v["params"]))
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    (want_train, *_), mut = jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), True,
        mutable=["batch_stats"])
    variables = {"params": params, "batch_stats": mut["batch_stats"]}
    want_eval = jm.apply(variables, jnp.asarray(x), False)[0]

    model = PointNetFeat(sym_op=sym_op, **MS)
    state = state_dict_from_flax(params, stats)
    model.load_state_dict(state, strict=True)
    assert {"stn1.fc0.weight", "stn2.bn0.running_var", "conv4.weight",
            "bn4.running_mean"} <= set(state)
    # the bridge both ways, and a reference .pth
    back = flax_from_state_dict(model.state_dict())
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(
            (params, stats))):
        np.testing.assert_array_equal(got, want)
    path = tmp_path / "ms.pth"
    torch.save({"module." + k: t for k, t in state.items()}, path)
    loaded = load_reference_pth(PointNetFeat(sym_op=sym_op, **MS), str(path))
    for key, val in loaded.state_dict().items():
        assert torch.equal(val, state[key]), key

    got_train = model(torch.from_numpy(x))[0]
    assert got_train.shape == (6, 64 * 4)
    np.testing.assert_allclose(got_train.detach().numpy(),
                               np.asarray(want_train), rtol=1e-4, atol=1e-4)
    want_stats = state_dict_from_flax(params, jax.tree.map(
        np.asarray, mut["batch_stats"]))
    for key, val in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(val.numpy(), want_stats[key].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    model.eval()
    with torch.inference_mode():
        got_eval = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-4)
