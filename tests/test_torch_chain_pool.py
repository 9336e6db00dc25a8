"""Port parity: the fused eval chain (``ops/kernels/chain_pool.py``).

On the CPU the wrappers take their plain PyTorch versions, which are held
here against the JAX Pallas kernel (interpret mode, fp32 operands) and its
literal oracle: the whole chain, and its two stages (layers 1-2, then layer
3 and the pool) composed, and the head's launch plan. The CUDA kernels
(``csrc/chain_head.cu``, ``csrc/chain_pool.cu``) are held against their
plain versions on the card by the ``cuda``-marked tests, at the model's
call-site shapes and at inputs aimed at a pooled tensor-core kernel's
pitfalls; ``chip_smoke.py`` runs the same check at the query path's batch.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops.kernels.chain_pool import (
    chain_head,
    chain_head_reference,
    chain_pool,
    chain_pool_reference,
    chain_tail,
    chain_tail_reference,
    fold_conv_bn,
    head_launch_plan,
    head_smem_bytes,
)

H100_SMS = 132


def _layers(rng, cin, widths=(64, 128, 256), scale_low=0.5):
    """(W, a, c) triples; scale_low < 0 draws some negative scales a."""
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


# the two stages the card runs, in their plain versions, composed
@pytest.mark.parametrize("b,n,cin", [(16, 300, 3), (8, 130, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_chain_stages_compose_to_jax(rng, b, n, cin, sym_op, relu_last):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import chain_kernel as ck

    x = (rng.randn(b, n, cin) * 0.5).astype(np.float32)
    layers = _layers(rng, cin, scale_low=-0.5)
    tl = _torch_layers(layers)
    h2 = chain_head(torch.from_numpy(x), tl[:2])
    assert h2.shape == (b, n, 128)
    torch.testing.assert_close(h2, chain_head_reference(torch.from_numpy(x),
                                                        tl[:2]))
    got = chain_tail(h2, tl[2], sym_op=sym_op, relu_last=relu_last).numpy()
    jl = tuple(tuple(jnp.asarray(t) for t in layer) for layer in layers)
    kern = np.asarray(ck.chain_pool(jnp.asarray(x), jl, sym_op=sym_op,
                                    relu_last=relu_last, interpret=True,
                                    bf16_operands=False))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-3)
    want = np.asarray(ck._chain_literal(jnp.asarray(x), jl, sym_op,
                                        relu_last))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


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
    before = chain_pool.launches, chain_head.launches
    out = chain_pool(x, layers)
    assert (chain_pool.launches, chain_head.launches) == before
    assert torch.equal(out, chain_pool_reference(x, layers))


def test_chain_stage_wrapper_checks(rng):
    x = torch.from_numpy((rng.randn(2, 5, 3)).astype(np.float32))
    layers = _torch_layers(_layers(rng, 3))
    with pytest.raises(ValueError):
        chain_head(x, layers)  # three layers where two are taken
    with pytest.raises(ValueError):
        chain_head(x.double(), layers[:2])
    h2 = chain_head(x, layers[:2])
    with pytest.raises(ValueError):
        chain_tail(h2, layers[1])  # 64 input channels, h2 has 128
    with pytest.raises(ValueError):
        chain_tail(h2, layers[2], sym_op="mean")
    with pytest.raises(ValueError):
        chain_tail(h2.transpose(0, 1), layers[2])
    before = chain_pool.launches, chain_head.launches
    out = chain_tail(h2, layers[2], sym_op="sum", relu_last=True)
    assert (chain_pool.launches, chain_head.launches) == before
    assert torch.equal(out, chain_tail_reference(h2, layers[2], sym_op="sum",
                                                 relu_last=True))


def test_head_smem_bytes():
    smem = head_smem_bytes()
    assert smem == 232000  # csrc/chain_head.cu SMEM_BYTES
    assert smem <= 232448  # a block's limit on sm_90
    assert 2 * smem > 233472  # an SM's 228 KB: one block per SM


def _worker_tiles(plan, block, worker):
    """csrc/chain_head.cu's walk: block ``block`` takes tiles block, block +
    blocks, ...; its two consumer warpgroups (workers) take them in turn."""
    step = plan["blocks"]
    return np.arange(block + worker * step, plan["tiles"], 2 * step)


# lengths of the flattened (B n) axis: one point, a ragged single tile, one
# whole tile, one point past it, and the largest call site (B 2048, n 1200)
@pytest.mark.parametrize("points", [1, 63, 64, 65, 2048 * 1200])
def test_head_launch_plan_covers_every_tile_once(points):
    plan = head_launch_plan(points, H100_SMS)
    tiles = plan["tiles"]
    assert (tiles - 1) * 64 < points <= tiles * 64
    assert plan["blocks"] == min(H100_SMS, tiles)
    assert plan["smem_bytes"] == head_smem_bytes()
    seen = np.zeros(tiles, dtype=np.int64)
    per_block = []
    for block in range(plan["blocks"]):
        got = [_worker_tiles(plan, block, w) for w in range(2)]
        for ts in got:
            np.add.at(seen, ts, 1)
        per_block.append(sum(ts.size for ts in got))
    assert (seen == 1).all()
    # every block takes its share: the counts differ by at most one
    assert max(per_block) - min(per_block) <= 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# the chain call sites of the bench models' forwards: (Cin, n points);
# p2s_large_kNN adds the last two
CALL_SITES = [(3, 1300), (64, 1000), (64, 300), (3, 1000), (64, 1200)]


def _card_inputs(device, b, n, cin, kind="random"):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    x = rng.randn(b, n, cin).astype(np.float32)
    layers = _layers(rng, cin, widths=(64, 128, 1024), scale_low=-0.5)
    if kind == "negative":
        # h2 >= 0 after its relu, so with W3 < 0 every layer-3 product is
        # negative (and, times a negative scale, positive): a zero-filled
        # row past n would win a max if it were not masked
        w3, a3, c3 = layers[2]
        layers[2] = (-np.abs(w3) - 1e-3, a3, c3)
    return (torch.from_numpy(x).to(device), _torch_layers(layers, device))


def _assert_close(got, want):
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin", [(64, 1300, 3), (64, 1000, 64),
                                     (64, 300, 64), (37, 129, 64),
                                     (1, 77, 3)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_chain_pool_kernel_matches_plain(cuda_device, b, n, cin, sym_op):
    x, tl = _card_inputs(cuda_device, b, n, cin)
    before = chain_pool.launches, chain_head.launches
    got = chain_pool(x, tl, sym_op=sym_op)
    torch.cuda.synchronize()
    assert (chain_pool.launches, chain_head.launches) == (before[0] + 1,
                                                          before[1] + 1)
    _assert_close(got, chain_pool_reference(x, tl, sym_op=sym_op))


# (b, n, cin): the call sites and ragged n at B 8 and 1; then a flattened
# length that is not a multiple of the 64-point tile (231); one shorter
# than a tile; one where every persistent block walks many tiles (38,400
# tiles); Cin a multiple of 4 below 64 (x by TMA, one box of 32 columns,
# the rest zero) and one that is not (plain loads, Cin padded to eight k8
# steps)
HEAD_CASES = [(b, n, cin) for cin, n in CALL_SITES + [(64, 129), (3, 77)]
              for b in (8, 1)] + [
    (3, 77, 64), (1, 37, 64), (1, 37, 3), (2048, 1200, 64), (3, 77, 16),
    (3, 77, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin", HEAD_CASES)
def test_chain_head_kernel_matches_plain(cuda_device, b, n, cin):
    x, tl = _card_inputs(cuda_device, b, n, cin)
    before = chain_head.launches
    got = chain_head(x, tl[:2])
    torch.cuda.synchronize()
    assert chain_head.launches == before + 1
    _assert_close(got, chain_head_reference(x, tl[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,n", [(3, 1300), (64, 1000)])
def test_chain_head_kernel_is_deterministic(cuda_device, cin, n):
    x, tl = _card_inputs(cuda_device, 64, n, cin)
    got = chain_head(x, tl[:2])
    again = chain_head(x, tl[:2])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, chain_head_reference(x, tl[:2]))


# (b, n, cin, kind): the call sites, ragged n (one point past a slab, less
# than one slab), B = 1 (the max splits the point axis), all-negative
# products
TAIL_CASES = [(8, n, cin, "random") for cin, n in CALL_SITES] + [
    (8, 129, 64, "random"), (8, 77, 64, "random"), (1, 1300, 3, "random"),
    (8, 129, 64, "negative"), (1, 77, 3, "negative"),
    (1, 1000, 64, "negative")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,kind", TAIL_CASES)
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_chain_tail_kernel_matches_plain(cuda_device, b, n, cin, kind,
                                         sym_op, relu_last):
    x, tl = _card_inputs(cuda_device, b, n, cin, kind)
    h2 = chain_head_reference(x, tl[:2])
    before = chain_pool.launches
    got = chain_tail(h2, tl[2], sym_op=sym_op, relu_last=relu_last)
    torch.cuda.synchronize()
    assert chain_pool.launches == before + 1
    _assert_close(got, chain_tail_reference(h2, tl[2], sym_op=sym_op,
                                            relu_last=relu_last))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1300), (3, 777), (64, 300)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_chain_pool_kernel_is_deterministic(cuda_device, b, n, sym_op):
    # the max may split the point axis and combine by atomics, which a max
    # does not feel; the sum never splits and adds in a fixed order
    x, tl = _card_inputs(cuda_device, b, n, 64, "negative")
    got = chain_pool(x, tl, sym_op=sym_op)
    again = chain_pool(x, tl, sym_op=sym_op)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, chain_pool_reference(x, tl, sym_op=sym_op))
