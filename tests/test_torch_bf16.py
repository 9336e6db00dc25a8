"""Port parity in the bf16-operand mode of the pooled kernels.

The JAX package's two Pallas kernels with a second numerics mode round
every operand of their products to bf16 (nearest even) and accumulate in
fp32: the train tail (``train_tail._kernel``, ``P2S_PALLAS_TAIL_PREC``) and
the eval chain (``chain_kernel._chain_kernel``, ``P2S_EVAL_CHAIN_PREC``).
The port selects the same mode from the same variables, except that an
unset variable means fp32 in the port and bf16 in JAX.

On the CPU the port's wrappers take their plain versions, held here
against the JAX kernels in interpret mode with ``bf16_operands=True``:

* the tail's reductions at ``tests/test_pallas.py``'s shapes and
  tolerances (max / min atol 1e-5, sums rtol 1e-5 / atol 1e-3, sums of
  squares rtol 1e-5 / atol 1e-2) and the arg contract (the rounded
  product at each arg index equals the pooled value, atol 1e-5);
* the chain at rtol 5e-4 / atol 5e-4 x max|ref|: both sides round the same
  values, but each sums its fp32 products in its own order, and where a
  sum lands on the other side of a bf16 rounding boundary the next layer's
  operand moves by one bf16 ulp (2^-8 relative). Measured: at most
  2.1e-4 x max|ref|; the port's fp32 mode is 1.6e-3 to 5.2e-3 x max|ref|
  away from JAX's bf16 chain, so the test tells the modes apart;
* the eval forward (``P2S_EVAL_CHAIN=1``) at rtol 1e-4 / atol 1e-5, for
  the same reason. Measured: at most 1.1e-6 (outputs up to 0.28); the
  port's fp32 forward is 1.2e-5 to 3.8e-5 away from JAX's bf16 forward;
* one fused train step at the tolerances of ``test_torch_train.py``
  (losses and metrics rtol 1e-4, gradients rtol 1e-3 / atol 1e-3 x max|g|),
  the transformers' last layers at zero; the updated state at rtol 1e-4 /
  atol 1e-5 (fp32 mode: 1e-6). Where the two packages' fp32 inputs of a
  tail straddle a bf16 rounding boundary, their operands differ by one
  bf16 ulp: in this step the losses then differ by 4e-5 (relative) against
  1e-6 in fp32 mode, and a zero-initialised transformer head, which one
  SGD step moves by 0.01 x its gradient, by 2.4e-6.

The ``cuda``-marked tests hold each bf16 kernel against its plain version
on the card and skip here.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.device import bf16_operands, round_bf16
from points2surf_tpu_torch.ops.kernels.chain_pool import (
    chain_head,
    chain_head_reference,
    chain_pool,
    chain_pool_reference,
    chain_tail,
    chain_tail_reference,
)
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_reductions,
    pooled_tail_reductions_reference,
)

TAIL_NAMES = ("cmax", "amax", "cmin", "amin", "rsum", "rsq")


def _tail_inputs(rng, b, n, cin, c):
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(cin, c) * 0.1).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, w, bias


def _chain_layers(rng, cin, widths=(64, 128, 256), scale_low=-0.5):
    """(W, a, c) triples, some scales a negative."""
    layers, ci = [], cin
    for co in widths:
        layers.append((
            (rng.randn(ci, co) * 0.2).astype(np.float32),
            (rng.rand(co) * (1.5 - scale_low) + scale_low).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32),
        ))
        ci = co
    return layers


def _torch_layers(layers, device="cpu"):
    return tuple(tuple(torch.from_numpy(t).to(device) for t in layer)
                 for layer in layers)


def _bf16_np(a):
    return round_bf16(torch.from_numpy(a)).numpy()


def _jax_env(monkeypatch, set_vars, del_vars):
    """Set / delete the JAX package's switches (read at trace time)."""
    jax = pytest.importorskip("jax")
    for k, v in set_vars.items():
        monkeypatch.setenv(k, v)
    for k in del_vars:
        monkeypatch.delenv(k, raising=False)
    jax.clear_caches()
    return jax


# (a) the train tail ------------------------------------------------------

@pytest.mark.parametrize("b,n,cin,c",
                         [(8, 130, 128, 128), (16, 300, 128, 256)])
def test_pooled_tail_bf16_matches_jax(rng, b, n, cin, c):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import train_tail

    x, w, bias = _tail_inputs(rng, b, n, cin, c)
    got = [g.numpy() for g in pooled_tail_reductions(
        *(torch.from_numpy(a) for a in (x, w, bias)), bf16_operands=True)]
    want = [np.asarray(o) for o in train_tail.pooled_tail_reductions(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True,
        bf16_operands=True)]
    dense = (_bf16_np(x).reshape(b * n, cin).astype(np.float64)
             @ _bf16_np(w) + bias).reshape(b, n, c)
    bb, cc = np.arange(b)[:, None], np.arange(c)[None, :]
    for out in (got, want):
        cmax, amax, cmin, amin, rsum, rsq = out
        np.testing.assert_allclose(cmax, dense.max(1), atol=1e-5)
        np.testing.assert_allclose(cmin, dense.min(1), atol=1e-5)
        np.testing.assert_allclose(rsum, dense.sum(1), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(rsq, (dense * dense).sum(1), rtol=1e-5,
                                   atol=1e-2)
        # the arg contract, in the mode's own numerics
        assert amax.dtype == np.int32 and amin.dtype == np.int32
        np.testing.assert_allclose(dense[bb, amax, cc], cmax, atol=1e-5)
        np.testing.assert_allclose(dense[bb, amin, cc], cmin, atol=1e-5)
    for name, g, j in zip(TAIL_NAMES, got, want):
        if g.dtype == np.int32:
            continue  # ties may differ; the value contract is checked above
        tol = dict(atol=1e-5) if name in ("cmax", "cmin") else dict(
            rtol=1e-5, atol=1e-3 if name == "rsum" else 1e-2)
        np.testing.assert_allclose(g, j, err_msg=name, **tol)


def test_pooled_tail_bf16_ties_keep_first_index(rng):
    x, w, bias = _tail_inputs(rng, 4, 40, 128, 64)
    x[:, 30:] = x[:, :1]  # ten copies of row 0 in every batch row
    got = pooled_tail_reductions_reference(
        *(torch.from_numpy(a) for a in (x, w, bias)), bf16_operands=True)
    assert bool((got[1] < 30).all()) and bool((got[3] < 30).all())


# (b) the eval chain ------------------------------------------------------

@pytest.mark.parametrize("b,n,cin", [(16, 300, 3), (8, 130, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_chain_bf16_matches_jax(rng, b, n, cin, sym_op):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import chain_kernel as ck

    x = (rng.randn(b, n, cin) * 0.5).astype(np.float32)
    layers = _chain_layers(rng, cin)
    tl = _torch_layers(layers)
    xt = torch.from_numpy(x)
    got = chain_pool(xt, tl, sym_op=sym_op, bf16_operands=True)
    assert torch.equal(got, chain_pool_reference(xt, tl, sym_op=sym_op,
                                                 bf16_operands=True))
    jl = tuple(tuple(jnp.asarray(t) for t in layer) for layer in layers)
    want = np.asarray(ck.chain_pool(jnp.asarray(x), jl, sym_op=sym_op,
                                    interpret=True, bf16_operands=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                               atol=5e-4 * float(np.abs(want).max()))
    # the bf16 mode is another numerics class than the fp32 one
    fp32 = chain_pool(xt, tl, sym_op=sym_op, bf16_operands=False)
    assert float((fp32 - got).abs().max()) > 1e-5


def test_chain_tail_rejects_the_other_dtype(rng):
    """The split stages are the fp32 class only: chain_tail refuses a bf16
    h2 and chain_pool a bf16 x, in either mode; nothing is cast."""
    x = torch.from_numpy(rng.randn(2, 5, 3).astype(np.float32))
    tl = _torch_layers(_chain_layers(rng, 3))
    h2 = chain_head(x, tl[:2])
    assert h2.dtype == torch.float32
    with pytest.raises(ValueError):
        chain_tail(h2.to(torch.bfloat16), tl[2])
    for mode in (False, True):
        with pytest.raises(ValueError):
            chain_pool(x.to(torch.bfloat16), tl, bf16_operands=mode)


def test_chain_stages_are_fp32_in_every_mode(monkeypatch, rng):
    """P2S_EVAL_CHAIN_PREC selects chain_pool's class and leaves the split
    stages alone: chain_head returns a float32 h2, and chain_tail of it
    equals the fp32 plain version, whatever the variable says."""
    x = torch.from_numpy(rng.randn(2, 9, 3).astype(np.float32))
    tl = _torch_layers(_chain_layers(rng, 3))
    want = chain_tail_reference(chain_head_reference(x, tl[:2]), tl[2])
    for value in (None, "highest", "default"):
        if value is None:
            monkeypatch.delenv("P2S_EVAL_CHAIN_PREC", raising=False)
        else:
            monkeypatch.setenv("P2S_EVAL_CHAIN_PREC", value)
        h2 = chain_head(x, tl[:2])
        assert h2.dtype == torch.float32
        assert torch.equal(chain_tail(h2, tl[2]), want)


# (c) the eval forward under P2S_EVAL_CHAIN -------------------------------

@pytest.mark.parametrize("variant,sym_op", [("vanilla", "max"),
                                            ("shared", "sum")])
def test_eval_forward_bf16_matches_jax(rng, monkeypatch, variant, sym_op):
    from test_torch_model import _batch, _jax_model, _torch_model

    m, params, stats = _jax_model(rng, variant, sym_op)
    model = _torch_model(variant, sym_op, params, stats)
    batch = _batch(rng)
    monkeypatch.setenv("P2S_EVAL_CHAIN_PREC", "default")
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    monkeypatch.delenv("P2S_EVAL_CHAIN_PREC")
    with torch.inference_mode():
        got_fp32 = model({k: torch.from_numpy(v) for k, v in batch.items()})

    jax = _jax_env(monkeypatch, {"P2S_EVAL_CHAIN": "1",
                                 "P2S_EVAL_CHAIN_INTERPRET": "1"},
                   ("P2S_EVAL_CHAIN_PREC",))  # JAX's default: bf16
    jnp = pytest.importorskip("jax.numpy")
    want = np.asarray(m.apply({"params": params, "batch_stats": stats},
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              False))
    for name in ("P2S_EVAL_CHAIN", "P2S_EVAL_CHAIN_INTERPRET"):
        monkeypatch.delenv(name)
    jax.clear_caches()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float((got - got_fp32).abs().max()) > 1e-6


# (d) one fused train step, JAX's Pallas tail in its default mode ---------

def test_fused_train_step_bf16_matches_jax(monkeypatch):
    jnp = pytest.importorskip("jax.numpy")
    optax = pytest.importorskip("optax")
    from points2surf_tpu_torch.models.weights import state_dict_from_flax
    from test_torch_train import (
        _assert_losses_metrics, _data, _jax_init, _jax_step, _port,
        _port_step)

    jax = _jax_env(monkeypatch, {"P2S_PALLAS_TAIL_INTERPRET": "1"},
                   ("P2S_PALLAS_TAIL_PREC",))  # JAX's default: bf16
    pts, q, gt = _data()
    m, params, stats = _jax_init("vanilla", "max")
    tx = optax.sgd(0.01, momentum=0.9)
    key = jax.random.key(11)
    new_p, new_bs, _, j_ll, j_metrics, grads = _jax_step(m, tx)(
        params, stats, tx.init(params), jnp.asarray(pts), jnp.asarray(q),
        jnp.asarray(gt), key)
    monkeypatch.delenv("P2S_PALLAS_TAIL_INTERPRET")
    jax.clear_caches()

    monkeypatch.setenv("P2S_PALLAS_TAIL_PREC", "default")
    steps = _port("vanilla", "max", params, stats, lr=0.01, momentum=0.9)
    losses, metrics = _port_step(steps, key, pts, q, gt)
    _assert_losses_metrics(losses, metrics, j_ll, j_metrics)
    want_g = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(steps.model.named_parameters())
    g_max = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in named.items():
        g = want_g[name].numpy()
        if np.abs(g).max() < 1e-6 * g_max:  # zero in exact arithmetic
            assert float(p.grad.abs().max()) < 1e-6 * g_max, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(g).max()),
                                   err_msg=name)
    want = state_dict_from_flax(*jax.tree.map(np.asarray, (new_p, new_bs)))
    got = steps.model.state_dict()
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)


# (e) the mode's resolution ------------------------------------------------

@pytest.mark.parametrize("value,want", [(None, False), ("highest", False),
                                        ("default", True)])
def test_mode_from_environment(monkeypatch, rng, value, want):
    for env in ("P2S_EVAL_CHAIN_PREC", "P2S_PALLAS_TAIL_PREC"):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
        assert bf16_operands(None, env) is want
        assert bf16_operands(not want, env) is (not want)  # a flag wins
    x, w, bias = (torch.from_numpy(a) for a in _tail_inputs(rng, 2, 9, 128,
                                                            16))
    for g, r in zip(pooled_tail_reductions(x, w, bias),
                    pooled_tail_reductions_reference(x, w, bias,
                                                     bf16_operands=want)):
        assert torch.equal(g, r)
    xc = torch.from_numpy(rng.randn(2, 9, 3).astype(np.float32))
    tl = _torch_layers(_chain_layers(rng, 3))
    assert torch.equal(chain_pool(xc, tl), chain_pool_reference(
        xc, tl, bf16_operands=want))


@pytest.mark.parametrize("value", ["", "HIGHEST", "bfloat16", "float32"])
def test_mode_rejects_other_values(monkeypatch, rng, value):
    monkeypatch.setenv("P2S_EVAL_CHAIN_PREC", value)
    monkeypatch.setenv("P2S_PALLAS_TAIL_PREC", value)
    with pytest.raises(ValueError):
        bf16_operands(None, "P2S_PALLAS_TAIL_PREC")
    x, w, bias = (torch.from_numpy(a) for a in _tail_inputs(rng, 2, 9, 128,
                                                            16))
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, bias)
    xc = torch.from_numpy(rng.randn(2, 9, 3).astype(np.float32))
    with pytest.raises(ValueError):
        chain_pool(xc, _torch_layers(_chain_layers(rng, 3)))


# (f) the kernels on the card ----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_tail(device, b, n, c, kind):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    x, w, bias = _tail_inputs(np.random.RandomState(0), b, n, 128, c)
    if kind == "negative":
        # every product x w < 0: TMA's zero rows past n would give c = b,
        # which wins the max, if they were not masked
        x, w = np.abs(x), -np.abs(w) - 1e-3
    x[:, n // 2:] = x[:, :1]  # duplicated rows: ties keep the first index
    return [torch.from_numpy(a).to(device) for a in (x, w, bias)]


def _assert_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,kind", [
    (64, 1300, 1024, "random"), (64, 1000, 1024, "random"),
    (64, 300, 1024, "random"), (37, 129, 1024, "random"),
    (5, 1, 1024, "random"), (3, 127, 1000, "random"),
    (64, 300, 1000, "negative"), (3, 127, 1000, "negative")])
def test_pooled_tail_bf16_kernel_matches_plain(cuda_device, b, n, c, kind):
    t = _card_tail(cuda_device, b, n, c, kind)
    before = (pooled_tail_reductions.launches,
              pooled_tail_reductions.launches_bf16)
    got = pooled_tail_reductions(*t, bf16_operands=True)
    again = pooled_tail_reductions(*t, bf16_operands=True)
    torch.cuda.synchronize()
    assert (pooled_tail_reductions.launches,
            pooled_tail_reductions.launches_bf16) == (before[0],
                                                      before[1] + 2)
    for name, g, a in zip(TAIL_NAMES, got, again):
        assert torch.equal(g, a), name  # reruns are bit-identical
    want = pooled_tail_reductions_reference(*t, bf16_operands=True)
    for name, g, r in zip(TAIL_NAMES, got, want):
        if g.dtype != torch.int32:
            _assert_close(g, r)
    # the arg contract in the kernel's numerics: the bf16 product there
    c_val = round_bf16(t[0]) @ round_bf16(t[1]) + t[2]
    for v, a in ((got[0], got[1]), (got[2], got[3])):
        _assert_close(torch.gather(c_val, 1, a.long()[:, None, :])[:, 0], v)
    first = max(n // 2, 1)
    assert bool((got[1] < first).all()) and bool((got[3] < first).all())


def _card_chain(device, b, n, cin, kind="random"):
    rng = np.random.RandomState(0)
    x = rng.randn(b, n, cin).astype(np.float32)
    layers = _chain_layers(rng, cin, widths=(64, 128, 1024))
    if kind == "negative":
        w3, a3, c3 = layers[2]
        layers[2] = (-np.abs(w3) - 1e-3, a3, c3)
    return torch.from_numpy(x).to(device), _torch_layers(layers, device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin", [(64, 1300, 3), (64, 300, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_chain_pool_bf16_kernels_match_plain(cuda_device, b, n, cin, sym_op):
    x, tl = _card_chain(cuda_device, b, n, cin)
    got = chain_pool(x, tl, sym_op=sym_op, bf16_operands=True)
    torch.cuda.synchronize()
    want = chain_pool_reference(x, tl, sym_op=sym_op, bf16_operands=True)
    # bf16 class: an h1 or h2 operand one bf16 ulp off (a straddle) moves
    # the pool by at most one bf16 ulp, 2^-8, of the largest output
    torch.testing.assert_close(got, want, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * float(want.abs().max()))
