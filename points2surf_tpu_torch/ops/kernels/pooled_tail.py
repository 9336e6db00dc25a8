"""Train-mode pooled-tail reductions: wrapper of ``csrc/pooled_tail.cu``.

Counterpart of ``points2surf_tpu/ops/pallas/train_tail.py``
(``pooled_tail_reductions``) in its fp32-operand mode. For
``c = x @ w + b`` with x (B, n, 128) it returns six (B, C) reductions over
the point axis, without keeping c:

    cmax, amax, cmin, amin, rsum, rsq

(max and its first arg index, min and its first arg index, sum, sum of
squares; arg indices int32). A CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel (3xTF32 ``wgmma`` fed by TMA), built with
``nvcc`` at its first use, or raises.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library)

KERNEL_CIN = 128  # the conv2 width that feeds every conv3 tail


def pooled_tail_reductions_reference(x: torch.Tensor, w: torch.Tensor,
                                     b: torch.Tensor):
    """Plain PyTorch version (materializes the (B, n, C) activation)."""
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
                           b: torch.Tensor):
    """All pooled-tail reductions of ``x @ w + b`` over the point axis.

    x (B, n, Cin) float32, w (Cin, C), b (C,). Returns (cmax, amax, cmin,
    amin, rsum, rsq), each (B, C); ties take the first index. On CUDA the
    kernel takes Cin == 128 and a 16-byte aligned x, any B and any n >= 1.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return pooled_tail_reductions_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"pooled_tail_reductions has no kernel for "
                         f"{x.device}")
    bsz, n, cin = x.shape
    if cin != KERNEL_CIN or x.data_ptr() % 16:
        raise ValueError(f"CUDA pooled_tail_reductions takes a 16-byte "
                         f"aligned x with Cin == {KERNEL_CIN}, got "
                         f"{tuple(x.shape)}")
    c = w.shape[1]
    # W^T split into tf32 hi and lo parts, (C, 128) each
    scratch = torch.empty(2 * c * cin, device=x.device, dtype=torch.float32)
    f32 = torch.empty((4, bsz, c), device=x.device, dtype=torch.float32)
    i32 = torch.empty((2, bsz, c), device=x.device, dtype=torch.int32)
    cmax, cmin, rsum, rsq = f32
    amax, amin = i32
    dev = x.device.index
    rc = _library().p2s_pooled_tail(
        dev, x.data_ptr(), bsz, n, cin, w.data_ptr(), b.data_ptr(), c,
        scratch.data_ptr(), cmax.data_ptr(), amax.data_ptr(),
        cmin.data_ptr(), amin.data_ptr(), rsum.data_ptr(), rsq.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev))
    check_launch("pooled_tail", rc)
    pooled_tail_reductions.launches += 1
    return cmax, amax, cmin, amin, rsum, rsq


pooled_tail_reductions.launches = 0


def _library():
    return load_library("pooled_tail", (
        ("p2s_pooled_tail", (CI, VP, CI, CI, CI, VP, VP, CI, VP,
                             VP, VP, VP, VP, VP, VP, VP)),
    ))
