"""SDF heads: losses, training metrics and prediction post-processing
(counterpart of ``points2surf_tpu/models/losses.py``)."""

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


def calc_loss_distance(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """MSE on tanh-squashed signed distances (reference sdf_nn.py:24-27)."""
    return torch.mean((torch.tanh(pred) - torch.tanh(target)) ** 2)


def calc_loss_magnitude(pred: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    """MSE on tanh-squashed absolute distances (reference sdf_nn.py:30-34)."""
    return torch.mean((torch.tanh(torch.abs(pred))
                       - torch.tanh(torch.abs(target))) ** 2)


def calc_loss_sign(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits (reference sdf_nn.py:37-40), in
    the stable form max(x, 0) - x z + log(1 + exp(-|x|))."""
    return torch.mean(torch.clamp(pred, min=0.0) - pred * target
                      + torch.log1p(torch.exp(-torch.abs(pred))))


def compute_loss(pred: torch.Tensor, batch: dict, outputs,
                 output_loss_weights: dict, fixed_radius: bool) -> list:
    """Weighted per-output losses (reference points_to_surf_train.py:537-563).
    In kNN mode (``fixed_radius`` False) the distance targets are divided by
    the patch radius, so the network regresses patch-space distances."""
    losses = []
    if "imp_surf" in outputs:
        target = batch["imp_surf_ms"].reshape(-1)
        if not fixed_radius:
            target = target / batch["patch_radius_ms"].reshape(-1)
        losses.append(calc_loss_distance(pred.reshape(-1), target)
                      * output_loss_weights["imp_surf"])
    if "imp_surf_magnitude" in outputs and "imp_surf_sign" in outputs:
        target = batch["imp_surf_magnitude_ms"].reshape(-1)
        if not fixed_radius:
            target = target / batch["patch_radius_ms"].reshape(-1)
        losses.append(calc_loss_magnitude(pred[:, 0], target)
                      * output_loss_weights["imp_surf_magnitude"])
        losses.append(calc_loss_sign(
            pred[:, 1], batch["imp_surf_dist_sign_ms"].reshape(-1))
            * output_loss_weights["imp_surf_sign"])
    return losses


def calc_metrics(outputs, pred: torch.Tensor, batch: dict) -> dict:
    """Training metrics (reference points_to_surf_train.py:566-595):
    abs_dist_rms, accuracy, precision, recall, f1_score as 0-d tensors, NaN
    where a denominator is empty (reference evaluation.py:8-36)."""
    if "imp_surf_magnitude" in outputs and "imp_surf_sign" in outputs:
        mag_pred = post_process_magnitude(pred[:, 0])
        gt_mag = torch.abs(batch["imp_surf_magnitude_ms"].reshape(-1))
        sign_pred = post_process_sign(pred[:, 1])
    elif "imp_surf" in outputs:
        mag_pred = post_process_magnitude(pred.reshape(-1))
        gt_mag = torch.abs(batch["imp_surf_ms"].reshape(-1))
        sign_pred = post_process_sign(pred.reshape(-1))
    else:
        return {}
    rms = torch.sqrt(torch.mean((torch.abs(mag_pred) - gt_mag) ** 2))
    p = sign_pred > 0.0
    g = batch["imp_surf_dist_sign_ms"].reshape(-1) > 0.0
    tp = torch.sum(p & g).float()
    fp = torch.sum(p & ~g).float()
    fn = torch.sum(~p & g).float()
    tn = torch.sum(~p & ~g).float()
    precision = tp / (tp + fp)  # NaN when no positive is predicted
    recall = tp / (tp + fn)
    return {
        "abs_dist_rms": rms,
        "accuracy": (tp + tn) / (tp + fp + fn + tn),
        "precision": precision,
        "recall": recall,
        "f1_score": 2.0 * precision * recall / (precision + recall),
    }
