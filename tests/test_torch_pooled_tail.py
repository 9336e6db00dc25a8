"""Port parity: the train-tail reductions (``ops/kernels/pooled_tail.py``) and
the autograd function over them (``models/pointnet._LinearPoolReductions``).

On the CPU the wrapper takes its plain PyTorch version, held here against
the JAX Pallas kernel in interpret mode with fp32 operands
(``P2S_PALLAS_TAIL_PREC=highest``), at the JAX package's own shapes and
tolerances (tests/test_pallas.py): max/min atol 2e-4, sums rtol 2e-4 /
atol 2e-3, sums of squares rtol 2e-4 / atol 2e-2, and the arg contract (the
value at the arg index equals the pooled value; ties may pick another
index). The forward and hand-derived backward of the pooled reductions are
held against ``jax.value_and_grad`` of ``_linear_pool_reductions`` at
rtol 1e-4 (value) and rtol / atol 1e-3 (gradients). The CUDA kernel is held
against the plain version on the card (``cuda``-marked tests).
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.pointnet import _LinearPoolReductions
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_reductions,
    pooled_tail_reductions_reference,
)


def _inputs(rng, b, n, cin, c):
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(cin, c) * 0.1).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, w, bias


def _check_reductions(out, x, w, bias):
    """Outputs against the dense float64 oracle, at the JAX test's
    tolerances."""
    cmax, amax, cmin, amin, rsum, rsq = (np.asarray(o) for o in out)
    b, n, cin = x.shape
    c = w.shape[1]
    dense = (x.reshape(b * n, cin).astype(np.float64) @ w + bias).reshape(
        b, n, c)
    np.testing.assert_allclose(cmax, dense.max(1), atol=2e-4)
    np.testing.assert_allclose(cmin, dense.min(1), atol=2e-4)
    np.testing.assert_allclose(rsum, dense.sum(1), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(rsq, (dense * dense).sum(1), rtol=2e-4,
                               atol=2e-2)
    bb = np.arange(b)[:, None]
    cc = np.arange(c)[None, :]
    assert amax.dtype == np.int32 and amin.dtype == np.int32
    np.testing.assert_allclose(dense[bb, amax, cc], cmax, atol=2e-4)
    np.testing.assert_allclose(dense[bb, amin, cc], cmin, atol=2e-4)


@pytest.fixture
def tail_highest(monkeypatch):
    jax = pytest.importorskip("jax")
    monkeypatch.setenv("P2S_PALLAS_TAIL_PREC", "highest")
    jax.clear_caches()  # read at trace time
    yield
    monkeypatch.delenv("P2S_PALLAS_TAIL_PREC")
    jax.clear_caches()


@pytest.mark.parametrize("b,n,cin,c",
                         [(16, 300, 128, 256), (8, 130, 128, 128)])
def test_pooled_tail_matches_jax(rng, tail_highest, b, n, cin, c):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import train_tail

    x, w, bias = _inputs(rng, b, n, cin, c)
    got = pooled_tail_reductions(*(torch.from_numpy(a) for a in (x, w, bias)))
    _check_reductions([g.numpy() for g in got], x, w, bias)
    want = train_tail.pooled_tail_reductions(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True)
    _check_reductions(want, x, w, bias)
    for g, j in zip(got, want):
        if g.dtype == torch.int32:
            continue  # ties may differ; the value contract is checked above
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_linear_pool_reductions_grad_matches_jax(rng, sym_op):
    """Value and gradients of sum(pooled^2) + sum(mean) + sum(var), the
    objective of the JAX package's own glue test."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.models import pointnet as jpn

    x, w, bias = _inputs(rng, 8, 70, 128, 128)
    need_minmax = sym_op == "max"

    def jax_fn(xx, ww, bb):
        cmax, cmin, csum, mean, var = jpn._linear_pool_reductions(
            xx, ww, bb, None, need_minmax, True)
        pooled = cmax + cmin if need_minmax else csum
        return jnp.sum(pooled * pooled) + jnp.sum(mean) + jnp.sum(var)

    want, want_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))

    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    out = _LinearPoolReductions.apply(*args, need_minmax)
    pooled = out[0] + out[1] if need_minmax else out[0]
    got = (pooled * pooled).sum() + out[-2].sum() + out[-1].sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for a, g in zip(args, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-3)


def test_linear_pool_reductions_grad_matches_autograd(rng):
    """The hand-derived backward against autograd of the literal stack
    (the second oracle), with ties: duplicated rows, as padded patches
    have."""
    x, w, bias = _inputs(rng, 4, 40, 128, 64)
    x[:, 30:] = x[:, :1]  # ten copies of row 0 in every batch row
    gens = [torch.from_numpy(a) for a in (x, w, bias)]
    weights = torch.from_numpy(rng.randn(4, 64, 4).astype(np.float32))

    def objective(cmax, cmin, mean, var):
        return ((cmax * weights[..., 0]).sum() + (cmin * weights[..., 1]).sum()
                + (mean * weights[0, :, 2]).sum()
                + (var * weights[0, :, 3]).sum())

    args = [g.clone().requires_grad_() for g in gens]
    objective(*_LinearPoolReductions.apply(*args, True)).backward()
    ref = [g.clone().requires_grad_() for g in gens]
    c = ref[0] @ ref[1] + ref[2]
    mean = c.mean(dim=(0, 1))
    var = (c * c).mean(dim=(0, 1)) - mean * mean
    objective(c.amax(1), c.amin(1), mean, var).backward()

    def merge_ties(g):  # rows 30.. are copies of row 0
        return torch.cat([g[:, :1] + g[:, 30:].sum(1, keepdim=True),
                          g[:, 1:30]], dim=1)

    # amax spreads a tie's gradient over the tied rows, the arg form routes
    # it to one of them: compare x's gradient summed over the tied rows
    torch.testing.assert_close(merge_ties(args[0].grad),
                               merge_ties(ref[0].grad), rtol=1e-4, atol=1e-4)
    for a, r in zip(args[1:], ref[1:]):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_pooled_tail_wrapper_checks(rng):
    x, w, bias = (torch.from_numpy(a) for a in _inputs(rng, 2, 5, 128, 16))
    with pytest.raises(ValueError):
        pooled_tail_reductions(x.double(), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x.transpose(0, 1), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x[..., :64].contiguous(), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x[:, :0], w, bias)
    # the plain version is what a CPU tensor takes; it launches nothing
    before = pooled_tail_reductions.launches
    out = pooled_tail_reductions(x, w, bias)
    assert pooled_tail_reductions.launches == before
    for o, r in zip(out, pooled_tail_reductions_reference(x, w, bias)):
        assert torch.equal(o, r)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(device, b, n, c, kind="random"):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    x, w, bias = _inputs(rng, b, n, 128, c)
    if kind == "negative":
        # every product x w < 0: TMA's zero rows past n would give c = b,
        # which wins the max, if they were not masked
        x, w = np.abs(x), -np.abs(w) - 1e-3
    x[:, n // 2:] = x[:, :1]  # duplicated rows: ties keep the first index
    return [torch.from_numpy(a).to(device) for a in (x, w, bias)]


# (b, n, C, kind): the train tails at batch 64 (n 1300, 1000, 300), ragged
# n (one past a slab, a single point, one short of a slab, exactly one
# slab), a ragged column tile (C 1000), all-negative products
CARD_CASES = [(64, 1300, 1024, "random"), (64, 1000, 1024, "random"),
              (64, 300, 1024, "random"), (37, 129, 1024, "random"),
              (5, 1, 1024, "random"), (3, 127, 1024, "random"),
              (2, 128, 1024, "random"), (37, 129, 1000, "random"),
              (64, 300, 1000, "negative"), (5, 1, 1024, "negative"),
              (3, 127, 1000, "negative")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,kind", CARD_CASES)
def test_pooled_tail_kernel_matches_plain(cuda_device, b, n, c, kind):
    t = _card_inputs(cuda_device, b, n, c, kind)
    before = pooled_tail_reductions.launches
    got = pooled_tail_reductions(*t)
    torch.cuda.synchronize()
    assert pooled_tail_reductions.launches == before + 1
    want = pooled_tail_reductions_reference(*t)
    for name, g, r in zip(("cmax", "amax", "cmin", "amin", "rsum", "rsq"),
                          got, want):
        if g.dtype == torch.int32:
            continue
        atol = 1e-4 * float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol, msg=name)
    c = t[0] @ t[1] + t[2]
    for v, a in ((got[0], got[1]), (got[2], got[3])):
        at = torch.gather(c, 1, a.long()[:, None, :])[:, 0]
        torch.testing.assert_close(at, v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))
    # rows n // 2 .. n - 1 copy row 0: a tie keeps the first index
    first = max(n // 2, 1)
    assert bool((got[1] < first).all()) and bool((got[3] < first).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1300), (3, 777), (64, 300)])
def test_pooled_tail_kernel_is_deterministic(cuda_device, b, n):
    # one block holds all of a row's points for its columns and reduces
    # them in a fixed order, the sums included
    t = _card_inputs(cuda_device, b, n, 1024, "negative")
    got = pooled_tail_reductions(*t)
    again = pooled_tail_reductions(*t)
    torch.cuda.synchronize()
    for name, g, a in zip(("cmax", "amax", "cmin", "amin", "rsum", "rsq"),
                          got, again):
        assert torch.equal(g, a), name


@pytest.mark.cuda
def test_pooled_tail_kernel_raises_on_other_cin(cuda_device):
    x = torch.zeros((2, 10, 64), device=cuda_device)
    w = torch.zeros((64, 32), device=cuda_device)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device))


@pytest.mark.cuda
def test_pooled_tail_kernel_raises_on_misaligned_x(cuda_device):
    # a contiguous view 4 bytes into its storage: TMA needs 16-byte bases
    x = torch.zeros(2 * 10 * 128 + 1, device=cuda_device)[1:].view(2, 10, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    w = torch.zeros((128, 32), device=cuda_device)
    before = pooled_tail_reductions.launches
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device))
    assert pooled_tail_reductions.launches == before
