"""Device selection and numerics policy.

Geometry (distances, rotations, the feature-STN rotation) must run in real
fp32: TF32 keeps ~10 mantissa bits, enough to reorder nearest neighbours
and break the patch-space normalization (max norm == 1). PyTorch lets
cuDNN convolutions use TF32 by default, so both switches are pinned here,
once, when the package is imported.

The pooled kernels (the eval chain, the train tail) have two numerics
classes, chosen per call by :func:`bf16_operands`.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def require_cuda(device: torch.device | str) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    GPU is present (nothing silently drops to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


def bf16_operands(flag: bool | None, env: str) -> bool:
    """The operand mode of a pooled kernel: ``flag`` when given, else the
    environment variable ``env`` (the JAX package's name for the same
    switch), read at call time.

    ``highest`` selects the fp32 class (3xTF32 products on the card);
    ``default`` selects bf16 operands (round to nearest even) with fp32
    accumulation, which is what that value means in the JAX package. Unset
    means ``highest``: the port's default, and its one deliberate
    difference from the JAX package, where an unset variable selects bf16.
    Any other value raises ``ValueError``.
    """
    if flag is not None:
        return bool(flag)
    value = os.environ.get(env, "highest")
    if value not in ("highest", "default"):
        raise ValueError(f"{env}={value!r}: expected 'highest' (fp32 "
                         f"operands) or 'default' (bf16 operands)")
    return value == "default"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 (ties to even), in ``t``'s dtype:
    the operand rounding of the bf16 mode (``astype(bfloat16)`` in XLA)."""
    return t.to(torch.bfloat16).to(t.dtype)
