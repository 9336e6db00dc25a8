"""Port parity: the encoder tail ``mlp_maxpool`` (``ops/kernels/mlp_maxpool.py``,
the JAX package's ``ops/pallas/encoder_tail.py``).

On the CPU the wrapper takes its plain PyTorch version, which is held here
against the JAX Pallas kernel (interpret mode, fp32 operands), its XLA
fallback and a float64 oracle. The CUDA kernel (3xTF32 ``wgmma``, TMA, a
split point axis combined by atomics) is held against the plain version on
the card by the ``cuda``-marked tests, each aimed at one way such a kernel
goes wrong; ``chip_smoke.py`` runs the same check at the measured shapes.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops.kernels.mlp_maxpool import (
    mlp_maxpool,
    mlp_maxpool_reference,
)


def _one_layer(rng, b, n, cin, cout, kind="random"):
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(cin, cout) * 0.1).astype(np.float32)
    c = rng.randn(cout).astype(np.float32)
    if kind == "negative":
        # every product x.W of every column is negative: a zero row (TMA's
        # fill past n) would win the max if it were not masked
        x, w = np.abs(x), -np.abs(w) - 1e-3
    elif kind == "ties":
        x[:, n // 3:] = x[:, :1]  # two thirds of the rows tie the max row
    return x, w, c


# inputs aimed at the kernel's pitfalls: (b, n, cin, cout, kind)
PITFALLS = [
    (3, 65, 128, 512, "negative"),    # a ragged last slab, all products < 0
    (2, 1, 128, 256, "negative"),     # one point: 127 zero-filled rows
    (4, 200, 64, 384, "ties"),        # rows that tie the max
    (1, 1000, 128, 1024, "random"),   # B = 1: the point axis is split
    (5, 63, 100, 1000, "negative"),   # Cin % 8 != 0, a ragged column tile
]


# the JAX package's encoder-tail tests (tests/test_pallas.py): the kernel
# shape in interpret mode, and an odd shape that takes its XLA fallback;
# then Cin 256 both ways (the kernel's own tiles, and the fallback)
@pytest.mark.parametrize("b,n,cin,kw", [
    (16, 256, 128, dict(interpret=True)),
    (6, 100, 128, {}),
    (8, 256, 256, dict(interpret=True, tb=8, tc=256, n_chunk=128)),
    (6, 100, 256, {}),
])
def test_mlp_maxpool_matches_jax(rng, b, n, cin, kw):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import encoder_tail

    x, w, c = _one_layer(rng, b, n, cin, 512)
    got = mlp_maxpool(*(torch.from_numpy(a) for a in (x, w, c))).numpy()
    want = np.asarray(encoder_tail.mlp_maxpool(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    dense = (x.astype(np.float64) @ w).max(1) + c
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,n,cin,cout,kind", PITFALLS)
def test_mlp_maxpool_pitfall_inputs_match_jax(rng, b, n, cin, cout, kind):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import encoder_tail

    x, w, c = _one_layer(rng, b, n, cin, cout, kind)
    got = mlp_maxpool(*(torch.from_numpy(a) for a in (x, w, c))).numpy()
    want = np.asarray(encoder_tail.mlp_maxpool(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c)))
    dense = (x.astype(np.float64) @ w).max(1) + c
    atol = 1e-4 * np.abs(dense).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=atol)


def test_mlp_maxpool_wrapper_checks(rng):
    x, w, c = (torch.from_numpy(a) for a in _one_layer(rng, 2, 5, 16, 8))
    with pytest.raises(ValueError):
        mlp_maxpool(x, w[:8].contiguous(), c)
    with pytest.raises(ValueError):
        mlp_maxpool(x, w, c[:4])
    with pytest.raises(ValueError):
        mlp_maxpool(x.double(), w, c)
    with pytest.raises(ValueError):
        mlp_maxpool(x.transpose(0, 1), w, c)
    with pytest.raises(ValueError):
        mlp_maxpool(x[:, :0].contiguous(), w, c)
    # the plain version is what a CPU tensor takes; it launches nothing
    before = mlp_maxpool.launches
    assert torch.equal(mlp_maxpool(x, w, c), mlp_maxpool_reference(x, w, c))
    assert mlp_maxpool.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(device, b, n, cin, cout, kind="random", x_offset=0):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    x, w, c = (torch.from_numpy(a).to(device)
               for a in _one_layer(rng, b, n, cin, cout, kind))
    if x_offset:  # a contiguous x whose base is not 16-byte aligned
        buf = torch.empty(x.numel() + x_offset, device=device)
        x = buf[x_offset:].view(b, n, cin).copy_(x)
    before = mlp_maxpool.launches
    got = mlp_maxpool(x, w, c)
    torch.cuda.synchronize()
    assert mlp_maxpool.launches == before + 1
    want = mlp_maxpool_reference(x, w, c)
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)
    return x, w, c, got


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout", [
    (64, 300, 128, 1024),   # the encoder-tail width at the local branch
    (16, 256, 128, 512),    # the JAX package's own test shape
    (37, 129, 3, 1000),
    (8, 1, 128, 512),       # n = 1
    (8, 63, 128, 512),      # n < one slab
    (8, 65, 128, 512),      # one point past half a slab
    (4, 1000, 128, 512),    # many slabs, split across blocks
    (1, 300, 128, 1024),    # B = 1
    (16, 300, 3, 256),      # Cin 3: padded to 4 (x) and 8 (W)
    (16, 300, 100, 256),    # Cin 100: padded to 104 (W)
    (16, 300, 256, 512),    # Cin 256 (refused by the earlier SIMT kernel)
    (6, 200, 128, 1000),    # Cout 1000: a ragged column tile
])
def test_mlp_maxpool_kernel_matches_plain(cuda_device, b, n, cin, cout):
    _kernel_vs_plain(cuda_device, b, n, cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,cout,kind", PITFALLS)
def test_mlp_maxpool_kernel_pitfalls(cuda_device, b, n, cin, cout, kind):
    _kernel_vs_plain(cuda_device, b, n, cin, cout, kind)


@pytest.mark.cuda
def test_mlp_maxpool_kernel_unaligned_x(cuda_device):
    _kernel_vs_plain(cuda_device, 4, 70, 128, 256, x_offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1000), (2, 777)])
def test_mlp_maxpool_kernel_is_deterministic(cuda_device, b, n):
    # the split point axis combines by atomics; a max does not depend on
    # their order, so two runs agree bit for bit
    x, w, c, got = _kernel_vs_plain(cuda_device, b, n, 128, 1024)
    again = mlp_maxpool(x, w, c)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
