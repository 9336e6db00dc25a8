"""Fused SDF query (counterpart of ``points2surf_tpu/infer/query.py``):
patch extraction, model forward and post-processing for a batch of query
points against a device-resident cloud, returning model-space signed
distances. This is the reconstruction inner loop.
"""

from __future__ import annotations

import numpy as np
import torch

from points2surf_tpu_torch.models import losses as L
from points2surf_tpu_torch.ops.patches import (
    PatchConfig, draw_batch, extract_patches)
from points2surf_tpu_torch.parallel.distributed import (
    gather_blocks, installed)
from points2surf_tpu_torch.utils import trace


def drain_batched_results(pending, n_total: int) -> np.ndarray:
    """Concatenate (B,) device results and fetch them as one host array."""
    if not pending:
        return np.empty(0, np.float32)
    with trace.span("query.fetch"), trace.blocking(pending[0].device):
        return torch.cat(pending)[:n_total].cpu().numpy()


def postprocess_sdf(pred: torch.Tensor, radius: torch.Tensor, outputs,
                    fixed_radius: bool) -> torch.Tensor:
    """Raw predictions (B, n_pred) -> (B,) model-space signed distances
    (tanh^2 magnitude times sign, scaled by the patch radius). Outputs other
    than the three predictions (``patch_pts_ids``, ``p_index``: debug
    plumbing) hold no column and are skipped. The result is float32 (bf16
    activations give bf16 predictions)."""
    dist = mag = sign = None
    dim = 0
    for o in outputs:
        if o == "imp_surf":
            d = L.post_process_distance(pred[:, dim])
            dist = d if fixed_radius else d * radius
            dim += 1
        elif o == "imp_surf_magnitude":
            m = L.post_process_magnitude(pred[:, dim])
            mag = m if fixed_radius else m * radius
            dim += 1
        elif o == "imp_surf_sign":
            sign = L.post_process_sign(pred[:, dim])
            dim += 1
    out = dist if dist is not None else mag * sign
    return out.to(torch.float32)


def make_sdf_query_fn(model: torch.nn.Module, outputs,
                      patch_cfg: PatchConfig, fixed_radius: bool,
                      augment: bool = False, coherent: bool = True,
                      mesh=None):
    """Returns ``fn(points, queries, n_valid, rng, small_cloud=False)`` ->
    (B,) signed distances. ``rng`` is a ``torch.Generator`` on the points'
    device or the batch's ``SubsampleDraws`` (``TrainDraws`` with
    ``augment``). Puts ``model`` in eval mode.

    ``augment`` extracts as in training (full-cloud selection and a random
    rotation per row, the reference's augmentation of every pass that is not
    a reconstruction) and runs the eval forward on it.

    With ``mesh`` (the grid ``parallel.mesh.make_mesh`` returned), the
    multi-rank sweep of the JAX package's ``mesh`` argument: each data rank
    extracts
    and evaluates its rows of the batch (its rows of the batch's draws),
    the forward column-sharded when ``model`` is
    (``parallel/sharding.partition_params``), and every rank returns the
    whole batch's distances. A batch that does not divide the data axis,
    or a ball-mode one (its tiles' priorities belong to the whole batch),
    runs whole on every rank, as JAX replicates what it cannot shard.
    """
    outputs = tuple(outputs)
    model.eval()

    @torch.inference_mode()
    def query(points, queries, n_valid, rng, small_cloud: bool = False):
        with trace.span("query.extract"):
            batch = extract_patches(points, queries, n_valid, rng,
                                    cfg=patch_cfg, train=augment,
                                    small_cloud=small_cloud,
                                    coherent=coherent)
        with trace.span("query.forward"):
            pred = model(batch)
        with trace.span("query.post"):
            return postprocess_sdf(pred, batch["patch_radius_ms"], outputs,
                                   fixed_radius)

    if mesh is None or installed(mesh).data == 1:
        return query

    @torch.inference_mode()
    def sharded_query(points, queries, n_valid, rng,
                      small_cloud: bool = False):
        b = queries.shape[0]
        if b % mesh.data or not patch_cfg.knn_mode:
            return query(points, queries, n_valid, rng, small_cloud)
        if isinstance(rng, torch.Generator):
            rng = draw_batch(rng, b, points.shape[0], patch_cfg, small_cloud,
                             train=augment, n_valid=n_valid)
        per = b // mesh.data
        lo, hi = mesh.data_index * per, (mesh.data_index + 1) * per
        mine = query(points, queries[lo:hi], n_valid,
                     rng.rows(lo, hi, chunk=patch_cfg.query_chunk),
                     small_cloud)
        return gather_blocks(mine, 0, mesh.data_group, mesh.data_index,
                             mesh.data)

    return sharded_query
