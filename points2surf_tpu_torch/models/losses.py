"""SDF post-processing (counterpart of ``points2surf_tpu/models/losses.py``).

The loss functions come with the training slice.
"""

from __future__ import annotations

import torch


def post_process_distance(pred: torch.Tensor) -> torch.Tensor:
    """tanh(pred)^2 * sign(pred) (reference sdf_nn.py:6-8)."""
    return torch.tanh(pred) ** 2 * torch.sign(pred)


def post_process_magnitude(pred: torch.Tensor) -> torch.Tensor:
    """tanh(pred)^2 (reference sdf_nn.py:11-13)."""
    return torch.tanh(pred) ** 2


def post_process_sign(pred: torch.Tensor) -> torch.Tensor:
    """Sign logits -> {-1.0, +1.0}; >= 0 maps to +1 (sdf_nn.py:16-21)."""
    return torch.where(pred >= 0.0, 1.0, -1.0).to(torch.float32)
