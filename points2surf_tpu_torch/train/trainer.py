"""The train steps (counterpart of the step-making parts of
``points2surf_tpu/train/trainer.py``: ``output_spec``, ``build_model``, the
SGD optimizer with its piecewise-constant learning rate, and the train,
eval and fused train steps).

One train step is the JAX package's: forward with batch statistics (running
statistics updated as flax does), the weighted losses, backward, then SGD
with momentum, ``t = g + momentum * t``, ``p -= lr(step) * t``, which is
what ``optax.sgd`` computes and what ``torch.optim.SGD`` with
``dampening=0`` computes. The learning rate is scaled by 0.1 at every
boundary ``step >= b`` (optax's ``piecewise_constant_schedule``). The
fused step runs train-mode patch extraction first.

The epoch loop, the data pipeline, checkpoints and logging are not ported
yet.
"""

from __future__ import annotations

import torch

from points2surf_tpu_torch.models import losses as L
from points2surf_tpu_torch.models.p2s import PointsToSurfModel
from points2surf_tpu_torch.ops.patches import PatchConfig, extract_patches


def output_spec(outputs):
    """Map the ``outputs`` flag list to prediction dims / names / weights
    (reference points_to_surf_train.py:200-249)."""
    pred_dim = 0
    names = []
    weights = {}
    for o in outputs:
        if o in ("imp_surf", "imp_surf_magnitude", "imp_surf_sign"):
            names.append(o)
            weights[o] = 1.0
            pred_dim += 1
        elif o in ("p_index", "patch_pts_ids"):
            pass  # debug plumbing, no prediction dims (:235-244)
        else:
            raise ValueError(f"Unknown output: {o}")
    if pred_dim <= 0:
        raise ValueError("Prediction is empty for the given outputs.")
    return pred_dim, names, weights


def build_model(opt, pred_dim: int) -> PointsToSurfModel:
    """The model of the training options ``opt`` (float32 only)."""
    if getattr(opt, "train_dtype", "float32") != "float32":
        raise NotImplementedError("train_dtype=bfloat16 is not ported yet")
    return PointsToSurfModel(
        net_size_max=opt.net_size,
        output_dim=pred_dim,
        use_point_stn=bool(opt.use_point_stn),
        use_feat_stn=bool(opt.use_feat_stn),
        sym_op=opt.sym_op,
        single_transformer=bool(opt.single_transformer),
        shared_transformation=bool(opt.shared_transformer),
    )


def learning_rate(step: int, lr: float, boundaries=()) -> float:
    """Piecewise-constant learning rate: ``lr`` times 0.1 for every
    boundary (in steps) with ``step >= boundary``."""
    return lr * 0.1 ** sum(step >= b for b in boundaries)


class TrainStep:
    """The train, eval and fused train steps of one model and its SGD state.

    ``train_step`` is ``forward_loss``, ``backward`` and ``update`` in turn;
    the gradients stay in the parameters' ``.grad`` after it.
    """

    def __init__(self, model: torch.nn.Module, outputs, *, lr: float = 0.01,
                 momentum: float = 0.9, boundaries=(),
                 patch_cfg: PatchConfig | None = None,
                 fixed_radius: bool = False):
        self.model = model
        self.outputs = tuple(outputs)
        _, _, self.loss_weights = output_spec(self.outputs)
        self.lr = lr
        self.boundaries = tuple(boundaries)
        self.patch_cfg = patch_cfg
        self.fixed_radius = fixed_radius
        self.optimizer = torch.optim.SGD(model.parameters(), lr=lr,
                                         momentum=momentum)
        self.step = 0

    def load_sgd_state(self, buffers: dict, count: int | None) -> None:
        """Momentum buffers under the ``state_dict`` names (see
        ``models.weights.sgd_state_from_checkpoint``) and the step count."""
        for name, p in self.model.named_parameters():
            self.optimizer.state[p]["momentum_buffer"] = (
                buffers[name].to(device=p.device, dtype=p.dtype).clone())
        if count is not None:
            self.step = count

    def forward_loss(self, batch: dict):
        """Train-mode forward and the weighted losses: (losses, pred)."""
        self.model.train()
        pred = self.model(batch)
        return L.compute_loss(pred, batch, self.outputs, self.loss_weights,
                              self.fixed_radius), pred

    def backward(self, losses) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        torch.stack(losses).sum().backward()

    def update(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate(self.step, self.lr, self.boundaries)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch: dict):
        """One SGD step on ``batch``: (losses (n_losses,), metrics)."""
        losses, pred = self.forward_loss(batch)
        self.backward(losses)
        self.update()
        with torch.no_grad():
            metrics = L.calc_metrics(self.outputs, pred, batch)
        return torch.stack(losses).detach(), metrics

    def eval_step(self, batch: dict):
        """Eval-mode losses and metrics of ``batch``; no state changes."""
        was_training = self.model.training
        self.model.eval()
        with torch.inference_mode():
            pred = self.model(batch)
            losses = L.compute_loss(pred, batch, self.outputs,
                                    self.loss_weights, self.fixed_radius)
            metrics = L.calc_metrics(self.outputs, pred, batch)
        self.model.train(was_training)
        return torch.stack(losses), metrics

    def extract_train_batch(self, points, queries, n_valid, gt, rng,
                            small_cloud: bool = False) -> dict:
        """Train-mode patches of ``queries`` with their ground-truth signed
        distances ``gt`` (B,)."""
        batch = extract_patches(points, queries, n_valid, rng,
                                cfg=self.patch_cfg, train=True,
                                small_cloud=small_cloud)
        batch["imp_surf_ms"] = gt
        batch["imp_surf_magnitude_ms"] = torch.abs(gt)
        batch["imp_surf_dist_sign_ms"] = (gt >= 0.0).to(torch.float32)
        return batch

    def train_step_fused(self, points, queries, n_valid, gt, rng,
                         small_cloud: bool = False):
        """Extraction (``rng``: a Generator or ``TrainDraws``) and one train
        step: (losses, metrics)."""
        return self.train_step(self.extract_train_batch(
            points, queries, n_valid, gt, rng, small_cloud))


def make_train_step(model: torch.nn.Module, outputs, **kwargs) -> TrainStep:
    """Steps of ``model``; keyword arguments as :class:`TrainStep`."""
    return TrainStep(model, outputs, **kwargs)
