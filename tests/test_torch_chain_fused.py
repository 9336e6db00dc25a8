"""The fused bf16 eval chain (``chain_fused``, ``csrc/chain_fused.cu``).

In the bf16-operand mode (``P2S_EVAL_CHAIN_PREC=default``) ``chain_pool`` on
a CUDA tensor runs the whole chain, layers 1-3 and the pool, in one kernel
on bf16 ``wgmma``. Its plain version is
``chain_pool_reference(..., bf16_operands=True)``. On the CPU this file
holds:

* the kernel's padding of Cin to a whole k16 step (Cin 3 -> 16): zero x
  columns against zero W1 rows leave the plain version bit for bit as it
  was, and the padded plain version matches the JAX kernel in interpret
  mode with ``bf16_operands=True`` at ``test_torch_bf16.py``'s rtol 5e-4 /
  atol 5e-4 x max|ref| (each side sums its fp32 products in its own order;
  a sum on the other side of a bf16 rounding boundary moves the next
  layer's operand by one bf16 ulp);
* the wrapper's argument checks, which raise before any launch;
* the launch plan the wrapper hands the kernel: shared memory within a
  block's 232,448 bytes, sum never split, every (row, tile) of every
  slice owned by exactly one worker of the static schedule.

The ``cuda``-marked tests hold the kernel against its plain version on the
card at rtol / atol 2^-8 x max|ref| (an h1 or h2 operand one bf16 ulp off
moves the pool by at most one bf16 ulp of the largest output; chip_smoke.py
phase 9's ``BF16_CHAIN_TOL``), check that reruns are bit-identical and that
a bf16 eval forward launches the fused kernel five times and the split
pair never; they skip here.
"""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops.kernels.chain_pool import (
    FUSED_SMEM_LIMIT,
    chain_fused,
    chain_head,
    chain_pool,
    chain_pool_reference,
    fused_launch_plan,
    fused_smem_bytes,
)

# chain call sites of the bench model's forward: (Cin, n points, count)
CHAIN_SITES = ((3, 1300, 1), (64, 1000, 2), (64, 300, 2))
PLAN_N = (1, 75, 77, 129, 1200, 1300)
PLAN_B = (1, 50, 100, 4096)
H100_SMS = 132
BF16_CHAIN_TOL = 2.0 ** -8


def _layers(rng, cin, widths=(64, 128, 256), scale_low=-0.5):
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


def _pad_cin(x, layers, k):
    """x and W1 zero-padded from Cin to k input channels."""
    (w1, a1, c1), rest = layers[0], layers[1:]
    cin = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, k - cin))
    w1p = torch.cat([w1, torch.zeros((k - cin, w1.shape[1]))])
    return xp, ((w1p, a1, c1),) + tuple(rest)


# (a) the plain version with Cin padded to a k16 step -----------------------

@pytest.mark.parametrize("b,n,cin", [(4, 300, 3), (2, 77, 3), (3, 129, 5)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_plain_padded_cin_is_exact(rng, b, n, cin, sym_op, relu_last):
    x = torch.from_numpy((rng.randn(b, n, cin) * 0.5).astype(np.float32))
    tl = _torch_layers(_layers(rng, cin))
    want = chain_pool_reference(x, tl, sym_op=sym_op, relu_last=relu_last,
                                bf16_operands=True)
    xp, tlp = _pad_cin(x, tl, 16)
    got = chain_pool_reference(xp, tlp, sym_op=sym_op, relu_last=relu_last,
                               bf16_operands=True)
    assert torch.equal(got, want)
    # the wrapper's CPU path is the same plain version
    assert torch.equal(chain_fused(xp, tlp, sym_op=sym_op,
                                   relu_last=relu_last), want)


@pytest.mark.parametrize("b,n,cin", [(16, 300, 3), (8, 130, 64)])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_padded_plain_matches_jax(rng, b, n, cin, sym_op, relu_last):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import chain_kernel as ck

    x = (rng.randn(b, n, cin) * 0.5).astype(np.float32)
    layers = _layers(rng, cin, scale_low=-0.5)
    xt, tl = torch.from_numpy(x), _torch_layers(layers)
    if cin < 16:
        xt, tl = _pad_cin(xt, tl, 16)
    got = chain_fused(xt, tl, sym_op=sym_op, relu_last=relu_last)
    jl = tuple(tuple(jnp.asarray(t) for t in layer) for layer in layers)
    want = np.asarray(ck.chain_pool(jnp.asarray(x), jl, sym_op=sym_op,
                                    relu_last=relu_last, interpret=True,
                                    bf16_operands=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                               atol=5e-4 * float(np.abs(want).max()))


# (b) the wrapper's checks ---------------------------------------------------

def _bad_call(case, rng):
    x = torch.from_numpy(rng.randn(2, 9, 3).astype(np.float32))
    tl = _torch_layers(_layers(rng, 3))
    if case == "cin":
        x = torch.from_numpy(rng.randn(2, 9, 65).astype(np.float32))
        tl = _torch_layers(_layers(rng, 65))
    elif case == "width1":
        tl = _torch_layers(_layers(rng, 3, widths=(32, 128, 256)))
    elif case == "width2":
        tl = _torch_layers(_layers(rng, 3, widths=(64, 64, 256)))
    elif case == "cout":
        tl = _torch_layers(_layers(rng, 3, widths=(64, 128, 200)))
    elif case == "dtype_x":
        x = x.double()
    elif case == "bf16_x":
        x = x.to(torch.bfloat16)
    elif case == "dtype_w":
        tl = (tuple(t.double() for t in tl[0]),) + tl[1:]
    elif case == "layers":
        tl = tl[:2]
    kw = {"sym_op": "mean"} if case == "sym_op" else {}
    return lambda: chain_fused(x, tl, **kw)


@pytest.mark.parametrize("case", ["cin", "width1", "width2", "cout",
                                  "dtype_x", "bf16_x", "dtype_w", "layers",
                                  "sym_op"])
def test_fused_wrapper_checks(rng, case):
    before = chain_pool.launches_fused_bf16
    with pytest.raises(ValueError):
        _bad_call(case, rng)()
    assert chain_pool.launches_fused_bf16 == before


def test_cpu_chain_pool_bf16_takes_the_plain_version(rng):
    x = torch.from_numpy(rng.randn(3, 40, 3).astype(np.float32))
    tl = _torch_layers(_layers(rng, 3))
    before = (chain_pool.launches_fused_bf16, chain_pool.launches,
              chain_head.launches)
    got = chain_pool(x, tl, bf16_operands=True)
    assert torch.equal(got, chain_pool_reference(x, tl, bf16_operands=True))
    assert torch.equal(got, chain_fused(x, tl))
    assert (chain_pool.launches_fused_bf16, chain_pool.launches,
            chain_head.launches) == before


# (c) the launch plan --------------------------------------------------------

def _owners(plan, batch):
    """How many workers own each (slice, row, tile), by the kernel's static
    schedule: worker w = g * bps + slot walks items w, w + workers, ..."""
    bps = plan["blocks"] // plan["slices"]
    workers = 2 * bps
    tiles, splits, per = plan["tiles"], plan["splits"], plan["per_split"]
    owned = np.zeros((batch, tiles), np.int64)
    busy = np.zeros(workers, bool)
    for w in range(workers):
        for i in range(w, plan["items"], workers):
            b, s = divmod(i, splits)
            owned[b, s * per:min(tiles, (s + 1) * per)] += 1
            busy[w] = True
    return owned, busy, bps


@pytest.mark.parametrize("batch", PLAN_B)
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_fused_launch_plan(batch, sym_op):
    assert fused_smem_bytes() == 227944  # csrc/chain_fused.cu SMEM_BYTES
    ns = sorted(set(PLAN_N) | {n for _, n, _ in CHAIN_SITES})
    for n in ns:
        plan = fused_launch_plan(batch, n, 1024, sym_op, H100_SMS)
        assert plan["smem_bytes"] <= FUSED_SMEM_LIMIT
        assert plan["slices"] == 2 and plan["tiles"] == -(-n // 64)
        assert plan["blocks"] % plan["slices"] == 0
        assert plan["slices"] <= plan["blocks"] <= H100_SMS
        if sym_op == "sum":
            assert plan["splits"] == 1
        splits, per = plan["splits"], plan["per_split"]
        assert (splits - 1) * per < plan["tiles"] <= splits * per
        assert plan["items"] == batch * splits
        owned, busy, bps = _owners(plan, batch)
        assert (owned == 1).all(), (batch, n)
        # every block has work for its first warpgroup
        assert busy[:bps].all()
        # a whole card whenever there are items for it
        if plan["items"] >= H100_SMS // 2:
            assert plan["blocks"] == H100_SMS


def test_fused_launch_plan_other_widths():
    for cout, slices in ((128, 1), (512, 1), (640, 2), (1536, 3)):
        plan = fused_launch_plan(7, 300, cout, "max", H100_SMS)
        assert plan["slices"] == slices
        assert plan["blocks"] % slices == 0
        assert (_owners(plan, 7)[0] == 1).all()


# (d) the kernel on the card -------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_chain(device, b, n, cin, kind, cout=1024):
    rng = np.random.RandomState(0)
    x = rng.randn(b, n, cin).astype(np.float32)
    layers = _layers(rng, cin, widths=(64, 128, cout))
    w3, a3, c3 = layers[2]
    if kind == "negative":
        # every layer-3 product < 0 (h2 >= 0): rows past n, if they were
        # not masked, would win the max with the affine of a zero row
        layers[2] = (-np.abs(w3) - 1e-3, a3, c3)
    elif kind == "negative_a":
        layers[2] = (w3, -np.abs(a3) - 0.1, c3)
    return torch.from_numpy(x).to(device), _torch_layers(layers, device)


def _assert_chain_close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=BF16_CHAIN_TOL,
                               atol=BF16_CHAIN_TOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cin,kind", [
    (64, 1300, 3, "random"), (64, 1000, 64, "random"),
    (64, 300, 64, "random"), (1, 1, 3, "random"), (1, 75, 64, "random"),
    (1, 77, 3, "negative"), (1, 129, 64, "negative_a"),
    (1, 1200, 64, "random"), (1, 1300, 3, "negative"),
    (50, 300, 64, "negative"), (100, 1000, 3, "negative_a"),
    (37, 129, 5, "random")])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
@pytest.mark.parametrize("relu_last", [False, True])
def test_fused_kernel_matches_plain(cuda_device, b, n, cin, kind, sym_op,
                                    relu_last):
    x, tl = _card_chain(cuda_device, b, n, cin, kind)
    before = (chain_pool.launches_fused_bf16, chain_pool.launches,
              chain_head.launches)
    got = chain_fused(x, tl, sym_op=sym_op, relu_last=relu_last)
    again = chain_fused(x, tl, sym_op=sym_op, relu_last=relu_last)
    torch.cuda.synchronize()
    assert (chain_pool.launches_fused_bf16, chain_pool.launches,
            chain_head.launches) == (before[0] + 2, *before[1:])
    assert got.shape == (b, 1024) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)  # reruns are bit-identical
    _assert_chain_close(got, chain_pool_reference(
        x, tl, sym_op=sym_op, relu_last=relu_last, bf16_operands=True))


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [128, 640])
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_fused_kernel_other_widths(cuda_device, cout, sym_op):
    """A slice of fewer than four column tiles (the rest read as zeros)."""
    x, tl = _card_chain(cuda_device, 5, 200, 64, "negative", cout)
    got = chain_fused(x, tl, sym_op=sym_op, relu_last=True)
    torch.cuda.synchronize()
    assert got.shape == (5, cout)
    _assert_chain_close(got, chain_pool_reference(
        x, tl, sym_op=sym_op, relu_last=True, bf16_operands=True))


@pytest.mark.cuda
@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_fused_kernel_at_the_query_batch(cuda_device, sym_op):
    """The five call sites at batch 4096 through chain_pool in bf16 mode;
    the plain version in row chunks."""
    for cin, n, _ in CHAIN_SITES:
        x, tl = _card_chain(cuda_device, 4096, n, cin, "random")
        got = chain_pool(x, tl, sym_op=sym_op, bf16_operands=True)
        again = chain_pool(x, tl, sym_op=sym_op, bf16_operands=True)
        want = torch.cat([chain_pool_reference(
            x[i:i + 256], tl, sym_op=sym_op, bf16_operands=True)
            for i in range(0, 4096, 256)])
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_chain_close(got, want)


@pytest.mark.cuda
def test_bf16_eval_forward_launches_only_the_fused_kernel(cuda_device,
                                                           monkeypatch):
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel

    torch.manual_seed(0)
    model = PointsToSurfModel(net_size_max=1024, output_dim=2,
                              shared_transformation=True).eval()
    model = model.to(cuda_device)
    rng = np.random.RandomState(0)
    batch = {
        "patch_pts_ps": rng.randn(8, 300, 3) * 0.3,
        "pts_sub_sample_ms": rng.randn(8, 1000, 3) * 0.3,
        "imp_surf_query_point_ms": rng.randn(8, 3) * 0.1,
    }
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(cuda_device)
             for k, v in batch.items()}
    monkeypatch.setenv("P2S_EVAL_CHAIN_PREC", "default")
    counters = ((chain_pool, "launches_fused_bf16"),
                (chain_pool, "launches"), (chain_head, "launches"))
    before = [getattr(f, a) for f, a in counters]
    with torch.inference_mode():
        pred = model(batch)
    torch.cuda.synchronize()
    after = [getattr(f, a) for f, a in counters]
    assert [a - b for a, b in zip(after, before)] == [5, 0, 0]
    assert pred.shape == (8, 2) and bool(torch.isfinite(pred).all())
