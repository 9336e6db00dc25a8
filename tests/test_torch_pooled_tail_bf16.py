"""The bf16-operand train tail (``pooled_tail_reductions`` with
``bf16_operands=True``, ``csrc/pooled_tail_bf16.cu``).

On a CUDA tensor the bf16 mode runs a kernel of its own: persistent blocks,
each keeping a 256-column slice of W^T and walking whole batch rows. Its
plain version is ``pooled_tail_reductions_reference(..., bf16_operands=True)``
(held against the JAX kernel in interpret mode in ``test_torch_bf16.py``).
On the CPU this file holds:

* the launch plan the wrapper hands the kernel, at the train tails' and
  ragged shapes: every (batch row, slice) item owned by exactly one block,
  each item every slab of its row (the point axis is never split, so sums
  and arg indices are reduced in one fixed order), the blocks that share a
  row neighbours in launch order, and shared memory within a block's
  232,448 bytes;
* the CPU wrapper taking the plain version and launching nothing.

The ``cuda``-marked tests hold the kernel against its plain version on the
card at rtol 1e-4 / atol 1e-4 x max|ref| (both sum the same exact bf16
products in fp32, in other orders), the value at each arg index against
the pooled value, first indices on ties, bit-identical reruns, the launch
counts, and the inputs the kernel refuses; they skip here.
"""

import collections

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.device import round_bf16
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    SMEM_LIMIT,
    bf16_launch_plan,
    bf16_smem_bytes,
    pooled_tail_reductions,
    pooled_tail_reductions_reference,
)

TAIL_NAMES = ("cmax", "amax", "cmin", "amin", "rsum", "rsq")
# the conv3 tails of a train step: n points (1300 once, 1000 and 300 twice)
TAIL_N = (1300, 1000, 300)
PLAN_B = (1, 2, 50, 100, 1000)
PLAN_C = (1, 128, 1000, 1024)
PLAN_N = (1, 75, 127, 129, 300, 1000, 1300)
H100_SMS = 132


# (a) the launch plan --------------------------------------------------------

def _block_items(plan, batch, block):
    """The items (batch row, slice, first slab, end slab) that block
    ``block`` walks, in order, as csrc/pooled_tail_bf16.cu computes them:
    slice block % slices, rows block // slices + k * (blocks // slices),
    every slab of a row."""
    slices = plan["slices"]
    step = plan["blocks"] // slices
    return [(row, block % slices, 0, plan["slabs"])
            for row in range(block // slices, batch, step)]


@pytest.mark.parametrize("batch", PLAN_B)
@pytest.mark.parametrize("cout", PLAN_C)
def test_bf16_launch_plan(batch, cout):
    assert bf16_smem_bytes() == 222280  # csrc/pooled_tail_bf16.cu SMEM_BYTES
    for n in sorted(set(PLAN_N) | set(TAIL_N)):
        plan = bf16_launch_plan(batch, n, cout, H100_SMS)
        slices, blocks = plan["slices"], plan["blocks"]
        assert plan["smem_bytes"] == bf16_smem_bytes() <= SMEM_LIMIT
        assert (slices - 1) * 256 < cout <= slices * 256
        assert blocks % slices == 0 and slices <= blocks <= H100_SMS
        assert plan["slabs"] == -(-n // 128)
        owners = collections.Counter()
        step = blocks // slices
        for block in range(blocks):
            items = _block_items(plan, batch, block)
            assert items, "a block without work"
            for k, (row, sl, s0, s1) in enumerate(items):
                assert (s0, s1) == (0, plan["slabs"])  # n is never split
                owners[(row, sl)] += 1
                # the blocks of a row are neighbours, at the same position
                assert block == (row % step) * slices + sl
                assert k == row // step
        assert owners == {(r, s): 1 for r in range(batch)
                          for s in range(slices)}, (batch, n, cout)
        # a whole card whenever the rows fill it
        if batch * slices >= H100_SMS:
            assert blocks > H100_SMS - slices


def test_cpu_bf16_mode_takes_the_plain_version():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 77, 128).astype(np.float32))
    w = torch.from_numpy(rng.randn(128, 40).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.randn(40).astype(np.float32))
    before = (pooled_tail_reductions.launches,
              pooled_tail_reductions.launches_bf16)
    got = pooled_tail_reductions(x, w, b, bf16_operands=True)
    want = pooled_tail_reductions_reference(x, w, b, bf16_operands=True)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert (pooled_tail_reductions.launches,
            pooled_tail_reductions.launches_bf16) == before


# (b) the kernel on the card -------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(device, b, n, c, kind):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    # post-relu activations, as conv3 receives them
    x = np.maximum(rng.randn(b, n, 128), 0).astype(np.float32)
    w = (rng.randn(128, c) / np.sqrt(128)).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    if kind == "negative":
        # every product x w <= 0: TMA's zero rows past n would give c = b,
        # which wins the max, if they were not masked
        w = -np.abs(w) - 1e-3
    x[:, n // 2:] = x[:, :1]  # duplicated rows: ties keep the first index
    return [torch.from_numpy(a).to(device) for a in (x, w, bias)]


def _assert_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _check_kernel(t, n):
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
    del again
    want = pooled_tail_reductions_reference(*t, bf16_operands=True)
    for name, g, r in zip(TAIL_NAMES, got, want):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype != torch.int32:
            _assert_close(g, r)
    del want
    # the arg contract in the kernel's numerics: the bf16 product there
    c_val = round_bf16(t[0]) @ round_bf16(t[1]) + t[2]
    for v, a in ((got[0], got[1]), (got[2], got[3])):
        assert bool(((a >= 0) & (a < n)).all())
        _assert_close(torch.gather(c_val, 1, a.long()[:, None, :])[:, 0], v)
    first = max(n // 2, 1)
    assert bool((got[1] < first).all()) and bool((got[3] < first).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", TAIL_N)
def test_bf16_kernel_at_the_train_tails(cuda_device, n):
    _check_kernel(_card_inputs(cuda_device, 1000, n, 1024, "random"), n)


# (b, n, C, kind): ragged n (a single point, one short of a slab, one past
# it, exactly one slab), ragged and narrow C (1000, 128, 1), fewer rows
# than SMs, all-negative products
CARD_CASES = [(37, 129, 1024, "random"), (5, 1, 1024, "random"),
              (3, 127, 1000, "random"), (2, 128, 1024, "random"),
              (100, 75, 1000, "random"), (50, 300, 128, "random"),
              (7, 300, 1, "random"), (1, 1300, 1024, "random"),
              (64, 300, 1000, "negative"), (5, 1, 1024, "negative"),
              (3, 127, 1000, "negative"), (1000, 300, 1024, "negative")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,kind", CARD_CASES)
def test_bf16_kernel_ragged(cuda_device, b, n, c, kind):
    _check_kernel(_card_inputs(cuda_device, b, n, c, kind), n)


@pytest.mark.cuda
def test_bf16_kernel_raises_on_other_cin(cuda_device):
    x = torch.zeros((2, 10, 64), device=cuda_device)
    w = torch.zeros((64, 32), device=cuda_device)
    before = pooled_tail_reductions.launches_bf16
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device),
                               bf16_operands=True)
    assert pooled_tail_reductions.launches_bf16 == before


@pytest.mark.cuda
def test_bf16_kernel_raises_on_misaligned_x(cuda_device):
    # a view 4 bytes past a 16-byte boundary: TMA needs a 16-byte base
    x = torch.zeros(2 * 10 * 128 + 1, device=cuda_device)[1:].view(2, 10, 128)
    assert x.data_ptr() % 16
    w = torch.zeros((128, 32), device=cuda_device)
    before = pooled_tail_reductions.launches_bf16
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device),
                               bf16_operands=True)
    assert pooled_tail_reductions.launches_bf16 == before
