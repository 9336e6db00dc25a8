"""Patch pipeline: turns sampler indices into batches on the card
(counterpart of ``points2surf_tpu/data/pipeline.py``).

The reference feeds the GPU from N CPU DataLoader workers, each running a
kd-tree query + numpy transforms per patch (source/data_loader.py:322-421,
source/points_to_surf_train.py:332-338). Here the host only does index
bookkeeping: batch indices are grouped into per-shape runs, each run is
extracted by :func:`extract_patches` against the device-resident cloud,
and the runs are re-assembled into the exact batch with one gather. GT
distances are small host arrays shipped alongside.

Every batch's random numbers come from one ``torch.Generator`` on the
store's device, seeded with ``seed``, through :meth:`PatchPipeline.draws`
(one call per extracted run, in the JAX package's order of ``next_key``
calls): the sub-sample's (the uniform mode's ids included), the rotations,
and in ball mode the selection's priorities, which the generator makes
while that run's selection runs. The JAX package pads each run to a
power-of-two bucket for XLA's compile cache; eager PyTorch has no such
cache, so runs are extracted at their own length here.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from points2surf_tpu_torch.data.shapes import ShapeStore
from points2surf_tpu_torch.ops.patches import (
    PatchConfig,
    SubsampleDraws,
    TrainDraws,
    draw_batch,
    extract_patches,
)
from points2surf_tpu_torch.utils import trace


class PatchPipeline:
    def __init__(
        self,
        store: ShapeStore,
        cfg: PatchConfig,
        *,
        augment: bool,
        seed: int = 0,
    ):
        self.store = store
        self.cfg = cfg
        self.augment = augment
        self.seed = seed
        self._gen = torch.Generator(device=store.device)
        self.reset()

    def reset(self) -> None:
        """Restart the random stream (reference --identical_epochs
        semantics: the same patches AND the same random draws every epoch,
        points_to_surf_train.py:99-100, data_loader.py:332-333)."""
        self._gen.manual_seed(self.seed)

    def draws(self, b: int, n: int, small_cloud: bool = False,
              n_valid: int | None = None) -> SubsampleDraws | TrainDraws:
        """The random numbers of the next extracted run of ``b`` queries
        against a cloud padded to ``n`` rows with ``n_valid`` valid ones:
        its sub-sample's, with ``augment`` one rotation per row
        (:class:`TrainDraws`), and in ball mode the selection's
        priorities."""
        return draw_batch(self._gen, b, n, self.cfg, small_cloud,
                          train=self.augment, n_valid=n_valid)

    def small_cloud(self, n_valid: int) -> bool:
        return n_valid < max(self.cfg.sub_sample_size, 1)

    def _extract_run(self, shape_ind: int, local_inds: np.ndarray) -> dict:
        with trace.span("data.extract"):
            pts_dev, n_valid = self.store.device_points(shape_ind)
            shape = self.store.get(shape_ind)
            with trace.span("data.upload"), \
                    trace.blocking(self.store.device):
                queries = torch.from_numpy(shape.query_pts[local_inds]).to(
                    self.store.device)
            small = self.small_cloud(n_valid)
            draws = self.draws(len(local_inds), pts_dev.shape[0], small,
                               n_valid=n_valid)
            return extract_patches(
                pts_dev, queries, n_valid, draws, cfg=self.cfg,
                train=self.augment, small_cloud=small,
            )

    def plan(
        self, indices: Iterable[int], batch_size: int
    ) -> Iterator[tuple]:
        """Yield per-batch plans without extracting.

        Each item is either
          ('single', shape_ind, local_inds, gt) — whole batch from one
            shape (the common case under shape-consecutive ordering;
            enables extraction fused into the train step), or
          ('mixed', batch_dict) — assembled via the two-phase path.
        """
        idx = np.fromiter(indices, dtype=np.int64)
        offsets = np.cumsum([0] + self.store.shape_patch_count)
        for start in range(0, len(idx), batch_size):
            with trace.span("data.plan"):
                chunk = idx[start : start + batch_size]
                shape_inds = np.searchsorted(offsets, chunk, side="right") - 1
                single = (len(chunk) == batch_size
                          and (shape_inds == shape_inds[0]).all())
                if single:
                    si = int(shape_inds[0])
                    li = chunk - offsets[si]
                    gt = self.store.get(si).query_dist[li].astype(np.float32)
            if single:
                yield ("single", si, li, gt)
            else:
                yield ("mixed", self._assemble(chunk, True))

    def batches(
        self,
        indices: Iterable[int],
        batch_size: int,
        *,
        with_gt: bool = True,
    ) -> Iterator[dict]:
        """Yield batch dicts on the store's device for consecutive chunks of
        ``indices``.

        Each batch carries the model-input keys plus (when ``with_gt``)
        'imp_surf_ms', 'imp_surf_magnitude_ms', 'imp_surf_dist_sign_ms'
        matching the reference batch contract (data_loader.py:395-404).
        """
        idx = np.fromiter(indices, dtype=np.int64)
        for start in range(0, len(idx), batch_size):
            yield self._assemble(idx[start : start + batch_size], with_gt)

    def _assemble(self, chunk: np.ndarray, with_gt: bool) -> dict:
        with trace.span("data.assemble"):
            offsets = np.cumsum([0] + self.store.shape_patch_count)
            shape_inds = np.searchsorted(offsets, chunk, side="right") - 1
            local_inds = chunk - offsets[shape_inds]

            run_outputs = []
            take_ids = np.empty(len(chunk), np.int64)
            gt = np.empty(len(chunk), np.float32) if with_gt else None
            row_base = 0
            # group into per-shape runs preserving order of first occurrence
            for si in _unique_stable(shape_inds):
                sel = shape_inds == si
                li = local_inds[sel]
                run_outputs.append(self._extract_run(int(si), li))
                take_ids[sel] = row_base + np.arange(len(li))
                if with_gt:
                    gt[sel] = self.store.get(int(si)).query_dist[li]
                row_base += len(li)

            if len(run_outputs) == 1:
                # one run: rows already in order
                batch = dict(run_outputs[0])
            else:
                with trace.span("data.upload"), \
                        trace.blocking(self.store.device):
                    take = torch.from_numpy(take_ids).to(self.store.device)
                batch = {
                    k: torch.cat([r[k] for r in run_outputs]).index_select(
                        0, take)
                    for k in run_outputs[0]
                }

            if with_gt:
                # sign target: 0.0 strictly negative else 1.0
                # (reference data_loader.py:369-371)
                dev = self.store.device
                with trace.span("data.upload"), trace.blocking(dev, 3):
                    batch["imp_surf_ms"] = torch.from_numpy(gt).to(dev)
                    batch["imp_surf_magnitude_ms"] = torch.from_numpy(
                        np.abs(gt)).to(dev)
                    batch["imp_surf_dist_sign_ms"] = torch.from_numpy(
                        (gt >= 0.0).astype(np.float32)).to(dev)
            return batch


def _unique_stable(arr: np.ndarray) -> np.ndarray:
    _, first = np.unique(arr, return_index=True)
    return arr[np.sort(first)]
