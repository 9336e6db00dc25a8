"""Fused eval chain + pool: wrappers of the CUDA kernels ``csrc/chain_head.cu``
(layers 1-2), ``csrc/chain_pool.cu`` (layer 3 and the pool) and
``csrc/chain_fused.cu`` (the whole chain in the bf16-operand class).

Counterpart of ``points2surf_tpu/ops/pallas/chain_kernel.py`` (``chain_pool``,
``_chain_literal``, ``fold_conv_bn``). Computes

    pool_n(L3(relu(L2(relu(L1(x))))))     L_i(h) = (h @ W_i) * a_i + c_i

(relu after L3 only with ``relu_last``), pooled by max or sum over the point
axis. A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
the kernels, built from the repository's sources with ``nvcc`` at their first
use, or raises. The one-layer encoder tail is ``mlp_maxpool.py``.

Two numerics classes, as in the JAX kernel; :func:`chain_pool`'s
``bf16_operands=None`` reads ``P2S_EVAL_CHAIN_PREC`` at call time
(``device.bf16_operands``):

* unset or ``highest``: fp32-class products (3xTF32 on the tensor cores:
  operands split into tf32 hi and lo, hi.hi + hi.lo + lo.hi in fp32). On
  the card the chain runs in two stages, both ``wgmma`` fed by TMA:
  :func:`chain_head` writes h2 = relu(L2(relu(L1(x)))) (B, n, 128) to
  device memory (persistent blocks over 64-point tiles, h1 in registers, h2
  stored by TMA), and :func:`chain_tail` runs L3, its affine and the pool;
* ``default``: every operand of every product (x, h1, h2 and each W_i) is
  rounded to bf16 (nearest even), products accumulate in fp32, the affines,
  relus and pools stay fp32. That class has one kernel, :func:`chain_fused`:
  all three layers and the pool on bf16 ``wgmma``, h1 and h2 in registers.

Unset means fp32 here; in the JAX package it means bf16. Launches count in
``chain_head.launches`` / ``chain_pool.launches`` (the fp32 stages) and
``chain_pool.launches_fused_bf16`` (the fused kernel).
"""

from __future__ import annotations

import ctypes

import torch

from points2surf_tpu_torch.device import bf16_operands as _resolve_mode
from points2surf_tpu_torch.device import round_bf16
from points2surf_tpu_torch.ops.kernels.build import (
    CI, VP, check_launch, load_library, sm_count)
from points2surf_tpu_torch.utils import trace

# widths the CUDA kernels are compiled for (conv1/conv2 of every trunk)
KERNEL_C1 = 64
KERNEL_C2 = 128
KERNEL_CIN_MAX = 64
PREC_ENV = "P2S_EVAL_CHAIN_PREC"

# csrc/chain_head.cu's launch plan: persistent blocks, one per SM, walk
# 64-point tiles of the flattened (B n) axis; a block's tiles alternate
# between its two consumer warpgroups (workers)
HEAD_TILE = 64
HEAD_STAGES = 4
HEAD_WORKERS_PER_BLOCK = 2


def head_smem_bytes() -> int:
    """Shared memory of a chain_head.cu block, by its plan (the kernel
    refuses a launch whose plan differs): W1^T and W2^T as tf32 hi and lo
    (fp32 each), the 4-stage ring of 64 x Cin_max x tiles, a 64 x 128 h2
    staging tile per worker, the packed affines, 8 mbarriers, and 1,024
    bytes to align the swizzled tiles."""
    w = 2 * (KERNEL_C1 * KERNEL_CIN_MAX + KERNEL_C2 * KERNEL_C1) * 4
    ring = HEAD_STAGES * HEAD_TILE * KERNEL_CIN_MAX * 4
    staging = HEAD_WORKERS_PER_BLOCK * HEAD_TILE * KERNEL_C2 * 4
    affines = 2 * (KERNEL_C1 + KERNEL_C2) * 4
    bars = 2 * HEAD_STAGES * 8
    return w + ring + staging + affines + bars + 1024


def head_launch_plan(points: int, sms: int) -> dict:
    """Grid of :func:`chain_head` over ``points`` flattened points on a card
    of ``sms`` SMs: tiles (64 points each, the last one ragged), blocks (one
    per SM, at most one per tile) and smem_bytes."""
    tiles = -(-points // HEAD_TILE)
    return {"tiles": tiles, "blocks": min(sms, tiles),
            "smem_bytes": head_smem_bytes()}


# csrc/chain_fused.cu's launch plan: 64-point tiles (one warpgroup's wgmma
# rows), slices of 512 columns of W3 resident per block, two consumer
# warpgroups (workers) per block, one block per SM
FUSED_TILE = 64
FUSED_SLICE = 512
FUSED_WORKERS_PER_BLOCK = 2
FUSED_SMEM_LIMIT = 232448  # bytes a block may have on sm_90


def fused_smem_bytes() -> int:
    """Shared memory of a chain_fused.cu block, by its plan (the kernel
    refuses a launch whose plan differs): the W3^T slice, W2^T and W1^T in
    128-byte bf16 rows, two warpgroups' 3-stage x rings of 64-point tiles,
    their four warps' pool partials, the packed affines, 13 mbarriers, and
    1,024 bytes to align the swizzled tiles."""
    row = 128
    w = (2 * FUSED_SLICE + KERNEL_C2 + KERNEL_C1) * row
    rings = FUSED_WORKERS_PER_BLOCK * 3 * FUSED_TILE * row
    red = FUSED_WORKERS_PER_BLOCK * 4 * FUSED_SLICE * 4
    affines = (KERNEL_C1 + KERNEL_C2 + FUSED_SLICE) // 2 * 16
    bars = (2 * FUSED_WORKERS_PER_BLOCK * 3 + 1) * 8
    return w + rings + red + affines + bars + 1024


def fused_launch_plan(batch: int, n: int, cout: int, sym_op: str,
                      sms: int) -> dict:
    """Grid and point split of :func:`chain_fused` on a card of ``sms`` SMs.

    Each block keeps one 512-column slice of W3 and holds two workers; a
    worker takes items (batch row, range of 64-point tiles) in a static
    order. Max splits a row's tiles over workers when the batch is at most
    half the workers (partials meet in an atomic max); sum never splits.
    Returns slices, tiles, splits, per_split (tiles per split), items (per
    slice), blocks and smem_bytes.
    """
    slices = -(-cout // FUSED_SLICE)
    tiles = -(-n // FUSED_TILE)
    per_slice = max(1, sms // slices)
    workers = per_slice * FUSED_WORKERS_PER_BLOCK
    # as many splits as leave no worker with more items than another
    splits = max(1, min(tiles, workers // batch)) if sym_op == "max" else 1
    per_split = -(-tiles // splits)
    splits = -(-tiles // per_split)
    items = batch * splits
    # worker w of a slice is warpgroup w // blocks of block w % blocks: the
    # first warpgroups of all blocks take items before the second ones do
    blocks = slices * min(per_slice, items)
    return {"slices": slices, "tiles": tiles, "splits": splits,
            "per_split": per_split, "items": items, "blocks": blocks,
            "smem_bytes": fused_smem_bytes()}


def chain_pool_reference(x: torch.Tensor, layers, *, sym_op: str = "max",
                         relu_last: bool = False,
                         bf16_operands: bool = False) -> torch.Tensor:
    """Plain PyTorch version (materializes every (B, n, C) activation).
    With ``bf16_operands`` each layer's input and weight are rounded to
    bf16 before an fp32 matmul (TF32 off, ``device.py``)."""
    h = x
    for li, (w, a, c) in enumerate(layers):
        if bf16_operands:
            h, w = round_bf16(h), round_bf16(w)
        h = torch.matmul(h, w) * a + c
        if li < len(layers) - 1 or relu_last:
            h = torch.relu(h)
    return torch.amax(h, dim=1) if sym_op == "max" else torch.sum(h, dim=1)


def chain_head_reference(x: torch.Tensor, layers) -> torch.Tensor:
    """Plain PyTorch version of :func:`chain_head`, in x's dtype."""
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
    c = bbias + (b - mean) * a. W stays unscaled, so the bf16 mode rounds
    W itself."""
    a = scale * torch.rsqrt(var + eps)
    c = bbias + (cbias - mean) * a
    return a, c


def _check(x: torch.Tensor, layers, count: int) -> None:
    if len(layers) != count:
        raise ValueError(f"expected {count} (W, a, c) layers, got "
                         f"{len(layers)}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (B, n, Cin) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
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
    """Layers 1-2 of the chain in the fp32 class: relu(L2(relu(L1(x)))),
    pointwise.

    x: (B, n, Cin) float32; layers: two (W, a, c) triples. Returns
    (B, n, C2) float32. On CUDA the kernel (``csrc/chain_head.cu``) takes
    Cin <= 64 and widths 64 -> 128: both layers on 3xTF32 ``wgmma``, x by
    TMA (or, for Cin not a multiple of 4 such as the point STN's 3, by plain
    loads), h1 in registers, h2 stored by TMA; its grid is
    :func:`head_launch_plan`'s.
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
    h2 = torch.empty((b, n, KERNEL_C2), device=x.device,
                     dtype=torch.float32)
    dev = x.device.index
    plan = head_launch_plan(b * n, sm_count(dev))
    with trace.span("kernel.chain"):
        rc = _head_library().p2s_chain_head(
            dev, x.data_ptr(), b * n, cin,
            w1.data_ptr(), a1.data_ptr(), c1.data_ptr(), KERNEL_C1,
            w2.data_ptr(), a2.data_ptr(), c2.data_ptr(), KERNEL_C2,
            h2.data_ptr(), plan["blocks"], plan["smem_bytes"],
            torch._C._cuda_getCurrentRawStream(dev))
    check_launch("chain_head", rc)
    chain_head.launches += 1
    return h2


def chain_tail(h: torch.Tensor, layer, *, sym_op: str = "max",
               relu_last: bool = False) -> torch.Tensor:
    """Layer 3 of the chain and the pool in the fp32 class:
    pool_n(act(L3(h))).

    h: (B, n, 128) float32, what :func:`chain_head` returns; another dtype
    raises, nothing is cast. layer: one (W, a, c) triple. Returns (B, Cout)
    float32. A launch counts in ``chain_pool.launches`` (the kernel of
    ``csrc/chain_pool.cu``).
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
    # One allocation: W^T (Cout, 128) split into tf32 hi and lo parts, then
    # out.
    wt_floats = 2 * cout * k
    buf = torch.empty(wt_floats + b * cout, device=h.device,
                      dtype=torch.float32)
    dev = h.device.index
    with trace.span("kernel.chain"):
        rc = _tail_library().p2s_chain_pool(
            dev, h.data_ptr(), b, n, k, w.data_ptr(), a.data_ptr(),
            c.data_ptr(), cout, int(sym_op == "max"), int(relu_last),
            buf.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    check_launch("chain_pool", rc)
    chain_pool.launches += 1
    return buf[wt_floats:].view(b, cout)


def chain_fused(x: torch.Tensor, layers, *, sym_op: str = "max",
                relu_last: bool = False) -> torch.Tensor:
    """The whole chain and the pool in the bf16-operand class, one kernel.

    x: (B, n, Cin) float32, Cin <= 64; layers: three (W, a, c) triples of
    widths 64, 128 and Cout, a multiple of 128. Returns (B, Cout) float32:
    ``chain_pool_reference(..., bf16_operands=True)``'s function, on the card
    by ``csrc/chain_fused.cu`` (h1 and h2 stay in registers), on the CPU by
    that plain version. Anything else raises, on either device, before a
    launch. A launch counts in ``chain_pool.launches_fused_bf16``.
    """
    if sym_op not in ("max", "sum"):
        raise ValueError(f"unsupported sym_op: {sym_op}")
    _check(x, layers, 3)
    (w1, a1, c1), (w2, a2, c2), (w3, a3, c3) = layers
    b, n, cin = x.shape
    cout = w3.shape[1]
    if (cin > KERNEL_CIN_MAX or w1.shape[1] != KERNEL_C1
            or w2.shape[1] != KERNEL_C2 or cout % 128):
        raise ValueError(
            f"chain_fused takes Cin <= {KERNEL_CIN_MAX}, widths {KERNEL_C1}/"
            f"{KERNEL_C2} and Cout a multiple of 128, got {cin}/"
            f"{w1.shape[1]}/{w2.shape[1]}/{cout}")
    if not _on_card(x, "chain_fused"):
        return chain_pool_reference(x, layers, sym_op=sym_op,
                                    relu_last=relu_last, bf16_operands=True)
    dev = x.device.index
    plan = fused_launch_plan(b, n, cout, sym_op, sm_count(dev))
    # One allocation: the bf16 W1^T (64 x 64), W2^T (128 x 64) and W3^T
    # (Cout x 128), half a float each, then out.
    wt_floats = (KERNEL_C1 * KERNEL_CIN_MAX + KERNEL_C2 * KERNEL_C1
                 + cout * KERNEL_C2) // 2
    buf = torch.empty(wt_floats + b * cout, device=x.device,
                      dtype=torch.float32)
    with trace.span("kernel.chain"):
        rc = _fused_library().p2s_chain_fused(
            dev, x.data_ptr(), b, n, cin, w1.data_ptr(), a1.data_ptr(),
            c1.data_ptr(), w2.data_ptr(), a2.data_ptr(), c2.data_ptr(),
            w3.data_ptr(), a3.data_ptr(), c3.data_ptr(), cout,
            int(sym_op == "max"), int(relu_last), plan["blocks"],
            plan["splits"], plan["per_split"], plan["smem_bytes"],
            buf.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    check_launch("chain_fused", rc)
    chain_pool.launches_fused_bf16 += 1
    return buf[wt_floats:].view(b, cout)


def chain_pool(x: torch.Tensor, layers, *, sym_op: str = "max",
               relu_last: bool = False,
               bf16_operands: bool | None = None) -> torch.Tensor:
    """Pool over points of a fused three-layer pointwise MLP.

    x: (B, n, Cin) float32; layers: three (W (Cin_i, Cout_i), a, c) triples
    (see :func:`fold_conv_bn`). Returns (B, Cout_3) float32.
    ``bf16_operands``: True rounds every product's operands to bf16, False
    keeps fp32-class products, None reads ``P2S_EVAL_CHAIN_PREC`` (unset:
    fp32). On CUDA the kernels take Cin <= 64 and the 64 -> 128 widths of
    the model's trunks: in fp32, h2 (B, n, 128) is the two stages' scratch;
    in bf16, :func:`chain_fused` runs the chain (Cout a multiple of 128).
    """
    if sym_op not in ("max", "sum"):
        raise ValueError(f"unsupported sym_op: {sym_op}")
    _check(x, layers, 3)
    bf16 = _resolve_mode(bf16_operands, PREC_ENV)
    if not _on_card(x, "chain_pool"):
        return chain_pool_reference(x, layers, sym_op=sym_op,
                                    relu_last=relu_last, bf16_operands=bf16)
    if bf16:
        return chain_fused(x, layers, sym_op=sym_op, relu_last=relu_last)
    return chain_tail(chain_head(x, layers[:2]), layers[2], sym_op=sym_op,
                      relu_last=relu_last)


chain_head.launches = 0
# launches of the layer-3 kernel, by chain_tail, and of the fused kernel
chain_pool.launches = 0
chain_pool.launches_fused_bf16 = 0


_HEAD_ENTRY_POINTS = (
    ("p2s_chain_head", (CI, VP, ctypes.c_longlong, CI, VP, VP, VP, CI, VP,
                        VP, VP, CI, VP, CI, CI, VP)),
)
_TAIL_ENTRY_POINTS = (
    ("p2s_chain_pool", (CI, VP, CI, CI, CI, VP, VP, VP, CI, CI, CI, VP,
                        VP)),
)
_FUSED_ENTRY_POINTS = (
    ("p2s_chain_fused", (CI, VP, CI, CI, CI, VP, VP, VP, VP, VP, VP, VP, VP,
                         VP, CI, CI, CI, CI, CI, CI, CI, VP, VP)),
)


def _head_library():
    return load_library("chain_head", _HEAD_ENTRY_POINTS)


def _tail_library():
    return load_library("chain_pool", _TAIL_ENTRY_POINTS)


def _fused_library():
    return load_library("chain_fused", _FUSED_ENTRY_POINTS)
