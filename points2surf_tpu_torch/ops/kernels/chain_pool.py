"""Fused eval chain + pool: wrappers of the CUDA kernels ``csrc/chain_head.cu``
(layers 1-2) and ``csrc/chain_pool.cu`` (layer 3 and the pool).

Counterpart of ``points2surf_tpu/ops/pallas/chain_kernel.py`` (``chain_pool``,
``_chain_literal``, ``fold_conv_bn``). Computes

    pool_n(L3(relu(L2(relu(L1(x))))))     L_i(h) = (h @ W_i) * a_i + c_i

(relu after L3 only with ``relu_last``), pooled by max or sum over the point
axis, in the fp32 numerics class. On the card it runs in two stages:
:func:`chain_head` writes h2 = relu(L2(relu(L1(x)))) (B, n, 128) to device
memory (SIMT fp32), and :func:`chain_tail` runs L3, its affine and the pool
on the tensor cores (3xTF32 ``wgmma`` fed by TMA). A CPU tensor takes the
plain PyTorch version; a CUDA tensor launches the kernels, built from the
repository's sources with ``nvcc`` at their first use, or raises. The
one-layer encoder tail is ``mlp_maxpool.py``.
"""

from __future__ import annotations

import ctypes

import torch

from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library)

# widths the CUDA kernels are compiled for (conv1/conv2 of every trunk)
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


def chain_head_reference(x: torch.Tensor, layers) -> torch.Tensor:
    """Plain PyTorch version of :func:`chain_head`."""
    h = x
    for w, a, c in layers:
        h = torch.relu(torch.matmul(h, w) * a + c)
    return h


def chain_tail_reference(h: torch.Tensor, layer, *, sym_op: str = "max",
                         relu_last: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`chain_tail` (materializes the
    (B, n, Cout) activation)."""
    return chain_pool_reference(h, (layer,), sym_op=sym_op,
                                relu_last=relu_last)


def fold_conv_bn(cbias, scale, bbias, mean, var, eps: float = 1e-5):
    """Eval (conv bias + BatchNorm) -> per-channel affine (a, c):
    ``bn(x @ W + b) == (x @ W) * a + c`` with a = scale / sqrt(var + eps),
    c = bbias + (b - mean) * a."""
    a = scale * torch.rsqrt(var + eps)
    c = bbias + (cbias - mean) * a
    return a, c


def _check(x: torch.Tensor, layers, count: int) -> None:
    if len(layers) != count:
        raise ValueError(f"expected {count} (W, a, c) layers, got "
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


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} has no kernel for {x.device}")
    return True


def chain_head(x: torch.Tensor, layers) -> torch.Tensor:
    """Layers 1-2 of the chain: relu(L2(relu(L1(x)))), pointwise.

    x: (B, n, Cin) float32; layers: two (W, a, c) triples. Returns
    (B, n, C2) float32. On CUDA the kernel takes Cin <= 64 and widths
    64 -> 128.
    """
    _check(x, layers, 2)
    if not _on_card(x, "chain_head"):
        return chain_head_reference(x, layers)
    (w1, a1, c1), (w2, a2, c2) = layers
    b, n, cin = x.shape
    if (cin > KERNEL_CIN_MAX or w1.shape[1] != KERNEL_C1
            or w2.shape[1] != KERNEL_C2):
        raise ValueError(
            f"CUDA chain_head takes Cin <= {KERNEL_CIN_MAX} and widths "
            f"{KERNEL_C1}/{KERNEL_C2}, got {cin}/{w1.shape[1]}/{w2.shape[1]}")
    h2 = torch.empty((b, n, KERNEL_C2), device=x.device, dtype=torch.float32)
    dev = x.device.index
    rc = _head_library().p2s_chain_head(
        dev, x.data_ptr(), b * n, cin,
        w1.data_ptr(), a1.data_ptr(), c1.data_ptr(), KERNEL_C1,
        w2.data_ptr(), a2.data_ptr(), c2.data_ptr(), KERNEL_C2,
        h2.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    check_launch("chain_head", rc)
    chain_head.launches += 1
    return h2


def chain_tail(h: torch.Tensor, layer, *, sym_op: str = "max",
               relu_last: bool = False) -> torch.Tensor:
    """Layer 3 of the chain and the pool: pool_n(act(L3(h))).

    h: (B, n, 128) float32 (what :func:`chain_head` returns); layer: one
    (W, a, c) triple. Returns (B, Cout) float32. A launch counts in
    ``chain_pool.launches`` (the kernel of ``csrc/chain_pool.cu``).
    """
    if sym_op not in ("max", "sum"):
        raise ValueError(f"unsupported sym_op: {sym_op}")
    _check(h, (layer,), 1)
    if not _on_card(h, "chain_tail"):
        return chain_tail_reference(h, layer, sym_op=sym_op,
                                    relu_last=relu_last)
    w, a, c = layer
    b, n, k = h.shape
    if k != KERNEL_C2 or h.data_ptr() % 16:
        raise ValueError(f"CUDA chain_tail takes a 16-byte aligned "
                         f"(B, n, {KERNEL_C2}) input, got {tuple(h.shape)}")
    cout = w.shape[1]
    # One allocation: W^T split into tf32 hi and lo parts, (Cout, 128) each,
    # then out.
    buf = torch.empty(2 * cout * k + b * cout, device=h.device,
                      dtype=torch.float32)
    dev = h.device.index
    rc = _tail_library().p2s_chain_pool(
        dev, h.data_ptr(), b, n, k, w.data_ptr(), a.data_ptr(),
        c.data_ptr(), cout, int(sym_op == "max"), int(relu_last),
        buf.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    check_launch("chain_pool", rc)
    chain_pool.launches += 1
    return buf[2 * cout * k:].view(b, cout)


def chain_pool(x: torch.Tensor, layers, *, sym_op: str = "max",
               relu_last: bool = False) -> torch.Tensor:
    """Pool over points of a fused three-layer pointwise MLP.

    x: (B, n, Cin) float32; layers: three (W (Cin_i, Cout_i), a, c) triples
    (see :func:`fold_conv_bn`). Returns (B, Cout_3) float32. On CUDA the
    kernels take Cin <= 64 and the 64 -> 128 widths of the model's trunks;
    h2 (B, n, 128) fp32 is their scratch.
    """
    if sym_op not in ("max", "sum"):
        raise ValueError(f"unsupported sym_op: {sym_op}")
    _check(x, layers, 3)
    if not _on_card(x, "chain_pool"):
        return chain_pool_reference(x, layers, sym_op=sym_op,
                                    relu_last=relu_last)
    return chain_tail(chain_head(x, layers[:2]), layers[2], sym_op=sym_op,
                      relu_last=relu_last)


chain_head.launches = 0
chain_pool.launches = 0  # launches of the layer-3 kernel, by chain_tail


_HEAD_ENTRY_POINTS = (
    ("p2s_chain_head", (CI, VP, ctypes.c_longlong, CI, VP, VP, VP, CI, VP,
                        VP, VP, CI, VP, VP)),
)
_TAIL_ENTRY_POINTS = (
    ("p2s_chain_pool", (CI, VP, CI, CI, CI, VP, VP, VP, CI, CI, CI, VP, VP)),
)


def _head_library():
    return load_library("chain_head", _HEAD_ENTRY_POINTS)


def _tail_library():
    return load_library("chain_pool", _TAIL_ENTRY_POINTS)
