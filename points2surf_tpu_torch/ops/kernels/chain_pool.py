"""Fused eval chain + pool: wrapper of the CUDA kernel ``csrc/chain_pool.cu``.

Counterpart of ``points2surf_tpu/ops/pallas/chain_kernel.py`` (``chain_pool``,
``_chain_literal``, ``fold_conv_bn``). Computes

    pool_n(L3(relu(L2(relu(L1(x))))))     L_i(h) = (h @ W_i) * a_i + c_i

(relu after L3 only with ``relu_last``), pooled by max or sum over the point
axis, in fp32. A CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel, built from the repository's source with ``nvcc`` at its
first use, or raises. The one-layer encoder tail is ``mlp_maxpool.py``.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library)

# widths the CUDA kernel is compiled for (conv1/conv2 of every trunk)
KERNEL_C1 = 64
KERNEL_C2 = 128
KERNEL_CIN_MAX = 64


def chain_pool_reference(x: torch.Tensor, layers, *, sym_op: str = "max",
                         relu_last: bool = False) -> torch.Tensor:
    """Plain PyTorch version (materializes every (B, n, C) activation)."""
    h = x
    for li, (w, a, c) in enumerate(layers):
        h = torch.matmul(h, w) * a + c
        if li < len(layers) - 1 or relu_last:
            h = torch.relu(h)
    return torch.amax(h, dim=1) if sym_op == "max" else torch.sum(h, dim=1)


def fold_conv_bn(cbias, scale, bbias, mean, var, eps: float = 1e-5):
    """Eval (conv bias + BatchNorm) -> per-channel affine (a, c):
    ``bn(x @ W + b) == (x @ W) * a + c`` with a = scale / sqrt(var + eps),
    c = bbias + (b - mean) * a."""
    a = scale * torch.rsqrt(var + eps)
    c = bbias + (cbias - mean) * a
    return a, c


def _check(x: torch.Tensor, layers) -> None:
    if len(layers) != 3:
        raise ValueError("expected 3 (W, a, c) layers, got "
                         f"{len(layers)}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, n, Cin) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty batch or point axis: {tuple(x.shape)}")
    ci = x.shape[2]
    for w, a, c in layers:
        for t in (w, a, c):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != x.device):
                raise ValueError("layer tensors must be contiguous float32 "
                                 f"on {x.device}")
        if w.dim() != 2 or w.shape[0] != ci:
            raise ValueError(f"weight {tuple(w.shape)} does not take {ci} "
                             "input channels")
        co = w.shape[1]
        if a.shape != (co,) or c.shape != (co,):
            raise ValueError(f"affine shapes {tuple(a.shape)}, "
                             f"{tuple(c.shape)} do not match width {co}")
        ci = co


def chain_pool(x: torch.Tensor, layers, *, sym_op: str = "max",
               relu_last: bool = False) -> torch.Tensor:
    """Pool over points of a fused three-layer pointwise MLP.

    x: (B, n, Cin) float32; layers: three (W (Cin_i, Cout_i), a, c) triples
    (see :func:`fold_conv_bn`). Returns (B, Cout_3) float32. On CUDA the
    kernel takes Cin <= 64 and the 64 -> 128 widths of the model's trunks.
    """
    if sym_op not in ("max", "sum"):
        raise ValueError(f"unsupported sym_op: {sym_op}")
    _check(x, layers)
    if x.device.type == "cpu":
        return chain_pool_reference(x, layers, sym_op=sym_op,
                                    relu_last=relu_last)
    if x.device.type != "cuda":
        raise ValueError(f"chain_pool has no kernel for {x.device}")
    (w1, a1, c1), (w2, a2, c2), (w3, a3, c3) = layers
    b, n, cin = x.shape
    if (cin > KERNEL_CIN_MAX or w1.shape[1] != KERNEL_C1
            or w2.shape[1] != KERNEL_C2):
        raise ValueError(
            f"CUDA chain_pool takes Cin <= {KERNEL_CIN_MAX} and widths "
            f"{KERNEL_C1}/{KERNEL_C2}, got {cin}/{w1.shape[1]}/{w2.shape[1]}")
    cout = w3.shape[1]
    out = torch.empty((b, cout), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = _library().p2s_chain_pool(
            x.data_ptr(), b, n, cin,
            w1.data_ptr(), a1.data_ptr(), c1.data_ptr(), w1.shape[1],
            w2.data_ptr(), a2.data_ptr(), c2.data_ptr(), w2.shape[1],
            w3.data_ptr(), a3.data_ptr(), c3.data_ptr(), cout,
            int(sym_op == "max"), int(relu_last), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check_launch("chain_pool", rc)
    chain_pool.launches += 1
    return out


chain_pool.launches = 0


_ENTRY_POINTS = (
    ("p2s_chain_pool", (VP, CI, CI, CI, VP, VP, VP, CI, VP, VP, VP, CI,
                        VP, VP, VP, CI, CI, CI, VP, VP)),
)


def _library():
    return load_library("chain_pool", _ENTRY_POINTS)
