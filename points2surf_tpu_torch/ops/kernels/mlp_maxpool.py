"""Encoder tail ``max_n(x @ W) + c``: wrapper of the CUDA kernel
``csrc/mlp_maxpool.cu``.

Counterpart of ``points2surf_tpu/ops/pallas/encoder_tail.py``
(``mlp_maxpool``): one pointwise layer with the BatchNorm folded into (W, c),
max-pooled over the point axis, c added after the pool, in the fp32 numerics
class (the kernel runs 3xTF32 products on the tensor cores). A CPU tensor
takes the plain PyTorch version; a CUDA tensor launches the kernel, built
from the repository's source with ``nvcc`` at its first use, or raises.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library)


def mlp_maxpool_reference(x: torch.Tensor, w: torch.Tensor,
                          c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mlp_maxpool` (materializes the
    (B, n, Cout) activation)."""
    return torch.amax(torch.matmul(x, w), dim=1) + c


def _check(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> None:
    # lean on purpose: at the small shapes the host's work per call is what
    # the caller waits for
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, n, Cin) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"empty batch, point or channel axis: "
                         f"{tuple(x.shape)}")
    on = x.get_device()
    for t in (w, c):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.get_device() != on):
            raise ValueError(f"w and c must be contiguous float32 on "
                             f"{x.device}")
    if w.dim() != 2 or w.shape[0] != x.shape[2] or w.shape[1] < 1:
        raise ValueError(f"weight {tuple(w.shape)} does not take "
                         f"{x.shape[2]} input channels")
    if c.shape != w.shape[1:]:
        raise ValueError(f"bias {tuple(c.shape)} does not match width "
                         f"{w.shape[1]}")


def mlp_maxpool(x: torch.Tensor, w: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """``max_n(x @ w) + c``: one pointwise layer, max pool, bias after the
    pool (the folded-BN encoder tail). x (B, n, Cin) float32, w (Cin, Cout),
    c (Cout,) -> (B, Cout) float32. On CUDA the kernel takes any Cin, n and
    Cout."""
    _check(x, w, c)
    device = x.device
    if device.type == "cpu":
        return mlp_maxpool_reference(x, w, c)
    if device.type != "cuda":
        raise ValueError(f"mlp_maxpool has no kernel for {device}")
    b, n, cin = x.shape
    cout = w.shape[1]
    if cin % 4 or x.data_ptr() % 16:
        # x's tensor map needs 16-byte rows and base: zero columns up to a
        # multiple of 4, exact since they meet the zero rows that the
        # kernel's prologue pads W with (to a multiple of 8, the tf32 k step)
        xp = x.new_zeros((b, n, -(-cin // 4) * 4))
        xp[..., :cin] = x
        x = xp
    kp = -(-cin // 8) * 8
    # One allocation: W^T split into tf32 hi and lo parts, (Cout, kp) each,
    # then out.
    buf = torch.empty(2 * cout * kp + b * cout, device=device,
                      dtype=torch.float32)
    rc = _library().p2s_mlp_maxpool(
        device.index, x.data_ptr(), b, n, x.shape[2], w.data_ptr(), cin,
        c.data_ptr(), cout, buf.data_ptr(),
        torch._C._cuda_getCurrentRawStream(device.index))
    check_launch("mlp_maxpool", rc)
    mlp_maxpool.launches += 1
    return buf[2 * cout * kp:].view(b, cout)


mlp_maxpool.launches = 0

_ENTRY_POINTS = (
    ("p2s_mlp_maxpool", (CI, VP, CI, CI, CI, VP, CI, VP, CI, VP, VP)),
)


def _library():
    return load_library("mlp_maxpool", _ENTRY_POINTS)
