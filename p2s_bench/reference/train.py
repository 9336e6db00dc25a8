"""Plain PyTorch reference of the first training steps: train-mode
forward (batch statistics), the two losses, autograd's backward and SGD with
momentum (``t = g + momentum * t``, ``p -= lr * t``; upstream
``torch.optim.SGD`` without dampening), from the benchmark's weights.

A batch is a list of runs, one per shape it draws from: the run's padded
cloud, its queries, their ground-truth distances, the run's draws and the
batch rows its queries fill.
"""

from __future__ import annotations

import torch

from reference import data
from reference.model import P2S


def batch_inputs(runs: list, patch: dict, depth: int, tf32: bool):
    """(patch points, radius, sub-sample, query, gt) of a batch, rows in
    batch order."""
    parts = []
    for run in runs:
        parts.append(data.patches(run["points"], run["n_valid"],
                                  run["queries"], run["draws"], patch, depth,
                                  train=True, tf32=tf32)
                     + (run["gt"],))
    pos = torch.cat([run["rows"] for run in runs])
    order = torch.argsort(pos)
    return tuple(torch.cat(t)[order] for t in zip(*parts))


def run_steps(cfg: dict, weights: dict, batches: list, tf32: bool = False):
    """Run ``len(batches)`` SGD steps from ``weights``. Returns (each step's
    losses summed, as floats; each parameter's first gradient; each
    parameter's change after the last step), the last two as dicts of
    tensors on the weights' device."""
    dev = next(iter(weights.values())).device
    model = P2S(cfg["model"]).to(dev)
    model.load_state_dict(weights)
    model.train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    trace = {k: None for k in params}
    lr, mom = cfg["train"]["lr"], cfg["train"]["momentum"]
    depth = cfg["train"]["subsample_candidates"]
    step_losses, first_grad = [], None
    for runs in batches:
        patch_ps, radius, sub, query, gt = batch_inputs(
            runs, cfg["patch"], depth, tf32)
        pred = model(patch_ps, sub, query, tf32)
        loss = data.losses(pred, gt, radius).sum()
        model.zero_grad(set_to_none=True)
        loss.backward()
        step_losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                trace[k] = g.clone() if trace[k] is None else g + mom * trace[k]
                p.sub_(lr * trace[k])
        if first_grad is None:
            first_grad = {k: t.clone() for k, t in trace.items()}
        del pred, loss, patch_ps, sub
    delta = {k: (p.detach() - start[k]) for k, p in params.items()}
    return step_losses, first_grad, delta
