"""Train-mode pooled-tail reductions: wrapper of ``csrc/pooled_tail.cu``
(fp32 class) and ``csrc/pooled_tail_bf16.cu`` (bf16-operand class).

Counterpart of ``points2surf_tpu/ops/pallas/train_tail.py``
(``pooled_tail_reductions``) in both of its numerics modes. For
``c = x @ w + b`` with x (B, n, 128) it returns six (B, C) reductions over
the point axis, without keeping c:

    cmax, amax, cmin, amin, rsum, rsq

(max and its first arg index, min and its first arg index, sum, sum of
squares; arg indices int32). ``bf16_operands`` picks the mode; ``None``
reads ``P2S_PALLAS_TAIL_PREC`` at call time (``device.bf16_operands``):
unset or ``highest`` is the fp32 class (3xTF32 ``wgmma``), ``default``
rounds x and w to bf16 (nearest even) and accumulates in fp32 (bf16
``wgmma``). Unset means fp32 here; in the JAX package it means bf16. A CPU
tensor takes the plain PyTorch version; a CUDA tensor launches the mode's
kernel (fed by TMA), built with ``nvcc`` at its first use, or raises.
Launches count in ``pooled_tail_reductions.launches`` (fp32) and
``.launches_bf16``.

The bf16 kernel runs persistent blocks from a launch plan computed here
(:func:`bf16_launch_plan`, pure Python, tested on the CPU): block i keeps
the 256-column slice i % slices of W^T and walks the whole batch rows
i // slices, + blocks // slices, ...; the kernel refuses a plan whose
shared-memory size differs from its own.

:func:`pooled_tail_grad` is the backward's one-hot half for the max pool
(``csrc/pooled_tail_grad.cu``, fp32 in both modes; counter
``pooled_tail_grad.launches``, span ``kernel.tail_grad``): the cotangents
of cmax and cmin routed to x's arg rows and to W, with no (B, C, Cin)
tensor and no atomics.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.device import bf16_operands as _resolve_mode
from points2surf_tpu_torch.device import round_bf16
from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library, sm_count)
from points2surf_tpu_torch.utils import trace

KERNEL_CIN = 128  # the conv2 width that feeds every conv3 tail
PREC_ENV = "P2S_PALLAS_TAIL_PREC"
# csrc/pooled_tail_grad.cu counts a batch row's entries into one shared-
# memory bin per point
GRAD_MAX_POINTS = 32768

# csrc/pooled_tail_bf16.cu's launch plan: a block keeps a slice of 256 W^T
# columns (two consumer warpgroups of 128) and walks 128-point slabs of its
# rows; one block per SM
BF16_SLICE = 256
BF16_SLAB = 128
SMEM_LIMIT = 232448  # bytes a block may have on sm_90


def bf16_smem_bytes() -> int:
    """Shared memory of a pooled_tail_bf16.cu block, by its plan (the kernel
    refuses a launch whose plan differs): the W^T slice in bf16, two bf16
    slab tiles, a slab's four fp32 staging chunks (128-byte rows each), the
    two warpgroups' four warps' six partials of 128 columns, 9 mbarriers,
    and 1,024 bytes to align the swizzled tiles."""
    row = 128
    w = BF16_SLICE * KERNEL_CIN * 2
    tiles = 2 * BF16_SLAB * KERNEL_CIN * 2
    staging = (KERNEL_CIN // 32) * BF16_SLAB * row
    partials = 2 * 4 * 6 * 128 * 4
    bars = (1 + KERNEL_CIN // 32 + 2 * 2) * 8
    return w + tiles + staging + partials + bars + 1024


def bf16_launch_plan(batch: int, n: int, cout: int, sms: int) -> dict:
    """Grid of :func:`pooled_tail_reductions`' bf16 kernel on a card of
    ``sms`` SMs: one block per SM, each keeping one 256-column slice of W^T,
    as many blocks per slice as the SMs allow and the batch fills. Returns
    slices, slabs (of 128 points per row: the kernel walks every slab of a
    row, the point axis is never split), blocks and smem_bytes."""
    slices = -(-cout // BF16_SLICE)
    per_slice = max(1, sms // slices)
    return {"slices": slices, "slabs": -(-n // BF16_SLAB),
            "blocks": slices * min(per_slice, batch),
            "smem_bytes": bf16_smem_bytes()}


def pooled_tail_reductions_reference(x: torch.Tensor, w: torch.Tensor,
                                     b: torch.Tensor, *,
                                     bf16_operands: bool = False):
    """Plain PyTorch version (materializes the (B, n, C) activation). With
    ``bf16_operands`` x and w are rounded to bf16 first; the product is an
    fp32 matmul of the rounded values (TF32 off, ``device.py``)."""
    if bf16_operands:
        x, w = round_bf16(x), round_bf16(w)
    c = torch.matmul(x, w) + b
    cmax, amax = torch.max(c, dim=1)
    cmin, amin = torch.min(c, dim=1)
    return (cmax, amax.to(torch.int32), cmin, amin.to(torch.int32),
            torch.sum(c, dim=1), torch.sum(c * c, dim=1))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (B, n, Cin) tensor, got "
                         f"{tuple(x.shape)}")
    for t in (x, w, b):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"x, w, b must be contiguous float32 on "
                             f"{x.device}")
    if w.dim() != 2 or w.shape[0] != x.shape[2] or b.shape != (w.shape[1],):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")


def pooled_tail_reductions(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, *,
                           bf16_operands: bool | None = None):
    """All pooled-tail reductions of ``x @ w + b`` over the point axis.

    x (B, n, Cin) float32, w (Cin, C), b (C,). Returns (cmax, amax, cmin,
    amin, rsum, rsq), each (B, C); ties take the first index.
    ``bf16_operands``: True rounds x and w to bf16, False keeps fp32-class
    products, None reads ``P2S_PALLAS_TAIL_PREC`` (unset: fp32). On CUDA
    either kernel takes Cin == 128 and a 16-byte aligned x, any B, any
    n >= 1 and any C >= 1.
    """
    _check(x, w, b)
    bf16 = _resolve_mode(bf16_operands, PREC_ENV)
    if x.device.type == "cpu":
        return pooled_tail_reductions_reference(x, w, b, bf16_operands=bf16)
    if x.device.type != "cuda":
        raise ValueError(f"pooled_tail_reductions has no kernel for "
                         f"{x.device}")
    bsz, n, cin = x.shape
    if cin != KERNEL_CIN or x.data_ptr() % 16:
        raise ValueError(f"CUDA pooled_tail_reductions takes a 16-byte "
                         f"aligned x with Cin == {KERNEL_CIN}, got "
                         f"{tuple(x.shape)}")
    c = w.shape[1]
    f32 = torch.empty((4, bsz, c), device=x.device, dtype=torch.float32)
    i32 = torch.empty((2, bsz, c), device=x.device, dtype=torch.int32)
    cmax, cmin, rsum, rsq = f32
    amax, amin = i32
    outs = (cmax.data_ptr(), amax.data_ptr(), cmin.data_ptr(),
            amin.data_ptr(), rsum.data_ptr(), rsq.data_ptr())
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if bf16:
        plan = bf16_launch_plan(bsz, n, c, sm_count(dev))
        # W^T (C, 128) in bf16
        scratch = torch.empty(c * cin, device=x.device, dtype=torch.bfloat16)
        with trace.span("kernel.tail"):
            rc = _bf16_library().p2s_pooled_tail_bf16(
                dev, x.data_ptr(), bsz, n, cin, w.data_ptr(), b.data_ptr(),
                c, plan["blocks"], plan["smem_bytes"], scratch.data_ptr(),
                *outs, stream)
        check_launch("pooled_tail_bf16", rc)
        pooled_tail_reductions.launches_bf16 += 1
    else:
        # W^T (C, 128) split into tf32 hi and lo parts
        scratch = torch.empty(2 * c * cin, device=x.device,
                              dtype=torch.float32)
        with trace.span("kernel.tail"):
            rc = _library().p2s_pooled_tail(
                dev, x.data_ptr(), bsz, n, cin, w.data_ptr(), b.data_ptr(),
                c, scratch.data_ptr(), *outs, stream)
        check_launch("pooled_tail", rc)
        pooled_tail_reductions.launches += 1
    return cmax, amax, cmin, amin, rsum, rsq


pooled_tail_reductions.launches = 0
pooled_tail_reductions.launches_bf16 = 0


def _library():
    return load_library("pooled_tail", (
        ("p2s_pooled_tail", (CI, VP, CI, CI, CI, VP, VP, CI, VP,
                             VP, VP, VP, VP, VP, VP, VP)),
    ))


def _bf16_library():
    return load_library("pooled_tail_bf16", (
        ("p2s_pooled_tail_bf16", (CI, VP, CI, CI, CI, VP, VP, CI, CI, CI,
                                  VP, VP, VP, VP, VP, VP, VP, VP)),
    ))


def pooled_tail_grad_reference(x, w, amax, amin, gmax, gmin, grad_x, grad_w):
    """Plain PyTorch version: for each arg, a scatter-add of g W^T into
    grad_x (in place) and a gather of x at the arg rows, both through a
    (B, C, Cin)-expanded index. Returns grad_w plus the gathered terms (a
    new tensor)."""
    bsz, _, cin = x.shape
    wt = w.t()
    for arg, g in ((amax, gmax), (amin, gmin)):
        idx = arg.long()[:, :, None].expand(bsz, w.shape[1], cin)
        grad_x.scatter_add_(1, idx, g[:, :, None] * wt)
        grad_w = grad_w + torch.sum(
            torch.gather(x, 1, idx) * g[:, :, None], dim=0).t()
    return grad_w


def pooled_tail_grad(x, w, amax, amin, gmax, gmin, grad_x, grad_w):
    """The one-hot terms of the max-pooled tail's backward
    (``models/pointnet._LinearPoolReductions``), in fp32: adds
    ``sum_{c: amax[b,c] = p} gmax[b,c] W[:, c]`` and the same of amin and
    gmin to ``grad_x[b, p]`` in place, and returns grad_w plus
    ``sum_b gmax[b,c] x[b, amax[b,c]] + gmin[b,c] x[b, amin[b,c]]`` in
    column c.

    x, grad_x (B, n, Cin); w, grad_w (Cin, C); amax, amin (B, C) int32 or
    int64; gmax, gmin (B, C). A CPU tensor takes the plain version, in any
    float dtype. A CUDA tensor launches the kernel, which updates grad_w in
    place and returns it, or raises: it takes float32, Cin == 128,
    n <= GRAD_MAX_POINTS and a 16-byte aligned x, any B and any C.
    """
    bsz, n, cin = x.shape
    c = w.shape[1]
    for t, shape in ((grad_x, x.shape), (w, (cin, c)), (grad_w, (cin, c)),
                     (amax, (bsz, c)), (amin, (bsz, c)), (gmax, (bsz, c)),
                     (gmin, (bsz, c))):
        if t.shape != shape or t.device != x.device:
            raise ValueError(f"pooled_tail_grad: a {tuple(t.shape)} tensor "
                             f"on {t.device} where {tuple(shape)} on "
                             f"{x.device} was due")
    if {amax.dtype, amin.dtype} - {torch.int32, torch.int64}:
        raise ValueError("pooled_tail_grad takes int32 or int64 arg indices")
    if x.device.type == "cpu":
        return pooled_tail_grad_reference(x, w, amax, amin, gmax, gmin,
                                          grad_x, grad_w)
    if x.device.type != "cuda":
        raise ValueError(f"pooled_tail_grad has no kernel for {x.device}")
    if (any(t.dtype != torch.float32 for t in (x, w, gmax, gmin, grad_x,
                                               grad_w))
            or cin != KERNEL_CIN or n > GRAD_MAX_POINTS or x.data_ptr() % 16
            or not all(t.is_contiguous() for t in (x, grad_x, grad_w))):
        raise ValueError(f"CUDA pooled_tail_grad takes float32 values, "
                         f"contiguous x, grad_x and grad_w, a 16-byte "
                         f"aligned x, Cin == {KERNEL_CIN} and n <= "
                         f"{GRAD_MAX_POINTS}, got x {tuple(x.shape)}")
    amax, amin = (a.to(torch.int32).contiguous() for a in (amax, amin))
    gmax, gmin = (g.contiguous() for g in (gmax, gmin))
    wt = w.t().contiguous()
    dev = x.device.index
    with trace.span("kernel.tail_grad"):
        rc = _grad_library().p2s_tail_grad(
            dev, x.data_ptr(), bsz, n, cin, wt.data_ptr(), c,
            amax.data_ptr(), amin.data_ptr(), gmax.data_ptr(),
            gmin.data_ptr(), grad_x.data_ptr(), grad_w.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev))
    check_launch("pooled_tail_grad", rc)
    pooled_tail_grad.launches += 1
    return grad_w


pooled_tail_grad.launches = 0


def _grad_library():
    return load_library("pooled_tail_grad", (
        ("p2s_tail_grad", (CI, VP, CI, CI, CI, VP, CI, VP, VP, VP, VP, VP,
                           VP, VP)),
    ))
