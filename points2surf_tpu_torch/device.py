"""Device selection and numerics policy.

Geometry (distances, rotations, the feature-STN rotation) must run in real
fp32: TF32 keeps ~10 mantissa bits, enough to reorder nearest neighbours
and break the patch-space normalization (max norm == 1). PyTorch lets
cuDNN convolutions use TF32 by default, so both switches are pinned here,
once, when the package is imported.
"""

from __future__ import annotations

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
