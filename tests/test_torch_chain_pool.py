"""Port parity: the fused eval chain (``ops/kernels/chain_pool.py``).

On the CPU the wrapper takes its plain PyTorch version, which is held
here against the JAX Pallas kernel (interpret mode, fp32 operands) and
its literal oracle. The CUDA kernel itself is held against the plain version on
the card (``cuda``-marked test below; ``chip_smoke.py`` runs the same check
at the model's call-site shapes).
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops.kernels.chain_pool import (
    chain_pool,
    chain_pool_reference,
    fold_conv_bn,
)


def _layers(rng, cin, widths=(64, 128, 256)):
    layers, ci = [], cin
    for co in widths:
        layers.append((
            (rng.randn(ci, co) * 0.2).astype(np.float32),
            (rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32),
        ))
        ci = co
    return layers


def _torch_layers(layers, device="cpu"):
    return tuple(tuple(torch.from_numpy(t).to(device) for t in layer)
                 for layer in layers)


# the shapes of the JAX package's own chain-kernel tests: ragged n, Cin 3
@pytest.mark.parametrize("b,n,cin", [(16, 300, 3), (8, 130, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_chain_pool_matches_jax(rng, b, n, cin, sym_op, relu_last):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import chain_kernel as ck

    x = (rng.randn(b, n, cin) * 0.5).astype(np.float32)
    layers = _layers(rng, cin)
    got = chain_pool(torch.from_numpy(x), _torch_layers(layers),
                     sym_op=sym_op, relu_last=relu_last).numpy()
    jl = tuple(tuple(jnp.asarray(t) for t in layer) for layer in layers)
    want = np.asarray(ck._chain_literal(jnp.asarray(x), jl, sym_op,
                                        relu_last))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    kern = np.asarray(ck.chain_pool(jnp.asarray(x), jl, sym_op=sym_op,
                                    relu_last=relu_last, interpret=True,
                                    bf16_operands=False))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-3)


def test_fold_conv_bn_matches_jax(rng):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import chain_kernel as ck

    c = 96
    cbias, scale, bbias, mean = (rng.randn(4, c) * 0.3).astype(np.float32)
    var = (rng.rand(c) + 0.1).astype(np.float32)
    args = (cbias, scale, bbias, mean, var)
    got = fold_conv_bn(*(torch.from_numpy(a) for a in args))
    want = ck.fold_conv_bn(None, *(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_chain_pool_wrapper_checks(rng):
    x = torch.from_numpy((rng.randn(2, 5, 3)).astype(np.float32))
    layers = _torch_layers(_layers(rng, 3))
    with pytest.raises(ValueError):
        chain_pool(x, layers[:2])
    with pytest.raises(ValueError):
        chain_pool(x, layers, sym_op="mean")
    with pytest.raises(ValueError):
        chain_pool(x.double(), layers)
    with pytest.raises(ValueError):
        chain_pool(x.transpose(0, 1), layers)
    with pytest.raises(ValueError):
        chain_pool(x[..., :2].contiguous(), layers)
    # the plain version is what a CPU tensor takes; it launches nothing
    before = chain_pool.launches
    out = chain_pool(x, layers)
    assert chain_pool.launches == before
    assert torch.equal(out, chain_pool_reference(x, layers))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin", [(64, 1300, 3), (64, 1000, 64),
                                     (37, 129, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_chain_pool_kernel_matches_plain(cuda_device, b, n, cin, sym_op):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(b, n, cin)).astype(np.float32))
    layers = _layers(rng, cin, widths=(64, 128, 1024))
    x, tl = x.to(cuda_device), _torch_layers(layers, cuda_device)
    before = chain_pool.launches
    got = chain_pool(x, tl, sym_op=sym_op)
    torch.cuda.synchronize()
    assert chain_pool.launches == before + 1
    want = chain_pool_reference(x, tl, sym_op=sym_op)
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)
