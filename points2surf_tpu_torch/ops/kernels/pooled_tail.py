"""Train-mode pooled-tail reductions: wrapper of ``csrc/pooled_tail.cu``.

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
tensor takes the plain PyTorch version; a CUDA tensor launches the kernel
(fed by TMA), built with ``nvcc`` at its first use, or raises. Launches
count in ``pooled_tail_reductions.launches`` (fp32) and ``.launches_bf16``.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.device import bf16_operands as _resolve_mode
from points2surf_tpu_torch.device import round_bf16
from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library)

KERNEL_CIN = 128  # the conv2 width that feeds every conv3 tail
PREC_ENV = "P2S_PALLAS_TAIL_PREC"


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
    the kernel takes Cin == 128 and a 16-byte aligned x, any B and any
    n >= 1.
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
    # W^T (C, 128): bf16, or split into tf32 hi and lo parts
    scratch = (torch.empty(c * cin, device=x.device, dtype=torch.bfloat16)
               if bf16 else
               torch.empty(2 * c * cin, device=x.device, dtype=torch.float32))
    f32 = torch.empty((4, bsz, c), device=x.device, dtype=torch.float32)
    i32 = torch.empty((2, bsz, c), device=x.device, dtype=torch.int32)
    cmax, cmin, rsum, rsq = f32
    amax, amin = i32
    dev = x.device.index
    rc = _library().p2s_pooled_tail(
        dev, x.data_ptr(), bsz, n, cin, w.data_ptr(), b.data_ptr(), c,
        int(bf16), scratch.data_ptr(), cmax.data_ptr(), amax.data_ptr(),
        cmin.data_ptr(), amin.data_ptr(), rsum.data_ptr(), rsq.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev))
    check_launch("pooled_tail", rc)
    if bf16:
        pooled_tail_reductions.launches_bf16 += 1
    else:
        pooled_tail_reductions.launches += 1
    return cmax, amax, cmin, amin, rsum, rsq


pooled_tail_reductions.launches = 0
pooled_tail_reductions.launches_bf16 = 0


def _library():
    return load_library("pooled_tail", (
        ("p2s_pooled_tail", (CI, VP, CI, CI, CI, VP, VP, CI, CI, VP,
                             VP, VP, VP, VP, VP, VP, VP)),
    ))
