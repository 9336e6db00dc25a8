"""Training traffic: SGD steps on the workload's training shapes, fed by the
port's ``data/`` pipeline as ``train/trainer.Trainer`` feeds its epoch loop,
in a closed loop (the next step is issued when the host is ready for it).

Per step, as the trainer's loop body: the ``ShapeStore``, the
``random_shape_consecutive`` sampler (``SequentialShapeRandomPatchSampler``)
and ``PatchPipeline.plan`` with one step of look-ahead; a batch from one
shape goes to ``TrainStep.train_step_fused`` (extraction inside the step),
a batch that spans two shapes (or the epoch's ragged last one) is extracted
by the pipeline and goes to ``TrainStep.train_step``; the next shape's cloud
is uploaded while the step is queued. No logging, checkpoints or
validation. The pipeline's draws are the benchmark's: each extracted run's
come from a generator seeded by (seed, call).

Set-up builds the one ``TrainStep`` and drives it through the epoch's first
three steps, which the check's reference follows; the window goes on with
the same object.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import data as ref_data
from reference import model as ref_model
from reference import train as ref_train

CHECKED_STEPS = 3


def _lookahead(it):
    prev, have = None, False
    for item in it:
        if have:
            yield prev, item
        prev, have = item, True
    if have:
        yield prev, None


class Traffic:
    checks = ("loss_step1_err", "grad_median_err", "delta_median_err")
    end_to_end = "train_patches_per_s"

    def __init__(self, ctx):
        from points2surf_tpu_torch.data.pipeline import PatchPipeline
        from points2surf_tpu_torch.data.samplers import (
            SequentialShapeRandomPatchSampler)
        from points2surf_tpu_torch.data.shapes import ShapeStore
        from points2surf_tpu_torch.models.p2s import PointsToSurfModel
        from points2surf_tpu_torch.ops.patches import PatchConfig, TrainDraws
        from points2surf_tpu_torch.train.trainer import TrainStep

        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.workload["params"]
        self.cfg, tr, pc, m = cfg, cfg["train"], cfg["patch"], cfg["model"]
        if tr["training_order"] != "random_shape_consecutive":
            raise ValueError(tr["training_order"])
        self.dev = dev = torch.device(ctx.device)
        self.batch = tr["batch_size"]
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(ctx.seed)
        self.weights = ref_model.seeded_weights(ref_model.P2S(m), self.gen)
        model = PointsToSurfModel(
            net_size_max=m["net_size"], output_dim=m["output_dim"],
            use_point_stn=m["use_point_stn"], use_feat_stn=m["use_feat_stn"],
            sym_op=m["sym_op"], single_transformer=m["single_transformer"],
            shared_transformation=m["shared_transformation"])
        ctx.load_weights(model, self.weights)
        self.model = model.to(dev)
        self.patch_cfg = PatchConfig(
            points_per_patch=pc["points_per_patch"],
            patch_radius=pc["patch_radius"],
            sub_sample_size=pc["sub_sample_size"],
            uniform_subsample=pc["uniform_subsample"],
            fixed_subsample=pc["fixed_subsample"],
            subsample_candidates=tr["subsample_candidates"])
        self.steps = TrainStep(self.model, tuple(cfg["outputs"]),
                               lr=tr["lr"], momentum=tr["momentum"],
                               patch_cfg=self.patch_cfg,
                               fixed_radius=pc["patch_radius"] > 0.0)
        self.root = ctx.root / p["dataset"]
        self.store = ShapeStore(str(self.root), p["shape_list"],
                                with_query=True,
                                cache_capacity=tr["cache_capacity"],
                                device=dev)
        self.sampler = SequentialShapeRandomPatchSampler(
            self.store.shape_patch_count, tr["patches_per_shape"],
            seed=ctx.seed % 2 ** 32)
        outer = self

        class Pipeline(PatchPipeline):
            """The pipeline with the benchmark's draws, logged per step while
            the checked steps run."""

            def draws(self, b, n, small_cloud=False, n_valid=None):
                outer.calls += 1
                outer.gen.manual_seed(ctx.seed * 2 ** 20 + outer.calls)
                d = ref_data.make_draws(outer.gen, b, n, n_valid, pc,
                                        tr["subsample_candidates"],
                                        train=True)
                if outer.log is not None:
                    outer.log.setdefault(outer.key, []).append(d)
                return TrainDraws(d["offset"], d["logu"], d["rot"],
                                  ids=d["ids"])

        self.calls, self.key, self.log = 0, None, {}
        self.pipe = Pipeline(self.store, self.patch_cfg, augment=True)
        self.items = _lookahead(self._plan())

        # the checked steps: the reference follows them after the window
        self.checked = []
        for s in range(CHECKED_STEPS):
            key, chunk, losses = self.step()
            self.checked.append((key, chunk, losses))
            if s == 0:  # the optimizer's trace after one step is g1
                state = self.steps.optimizer.state
                self.first_grad = {
                    k: state[p]["momentum_buffer"].detach().clone()
                    if "momentum_buffer" in state.get(p, {})
                    else torch.zeros_like(p)
                    for k, p in self.model.named_parameters()}
        self.delta = {k: p.detach() - self.weights[k].to(dev)
                      for k, p in self.model.named_parameters()}
        self.checked_draws, self.log = self.log, None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _plan(self):
        """(epoch and batch, the batch's sampler indices, the plan's item),
        epoch after epoch."""
        epoch = 0
        while True:
            idx = np.fromiter(iter(self.sampler), dtype=np.int64)
            plan = self.pipe.plan(idx, self.batch)
            for j, start in enumerate(range(0, len(idx), self.batch)):
                self.key = (epoch, j)
                yield self.key, idx[start:start + self.batch], next(plan)
            epoch += 1

    def step(self):
        """One step as the trainer's loop body runs it: (its key, its
        sampler indices, its losses)."""
        spans, dev = self.ctx.spans, self.dev
        with spans("data"):
            (key, chunk, item), nxt = next(self.items)
            self.key = key
            if item[0] == "single":
                _, si, li, gt = item
                pts, nv = self.store.device_points(si)
                shape = self.store.get(si)
                small = self.pipe.small_cloud(nv)
                draws = self.pipe.draws(len(li), pts.shape[0], small,
                                        n_valid=nv)
                q = torch.from_numpy(shape.query_pts[li]).to(dev)
                gt = torch.from_numpy(gt).to(dev)
        with spans("step"):
            if item[0] == "single":
                losses, _ = self.steps.train_step_fused(pts, q, nv, gt, draws,
                                                        small_cloud=small)
            else:
                losses, _ = self.steps.train_step(item[1])
        with spans("data"):
            nxt_item = None if nxt is None else nxt[2]
            if (nxt_item is not None and nxt_item[0] == "single"
                    and (item[0] != "single" or nxt_item[1] != item[1])):
                self.store.device_points(nxt_item[1])
        return key, chunk, losses

    # -- the window ---------------------------------------------------------

    def window(self, seconds: float) -> dict:
        rows = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            rows.append(len(self.step()[1]))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        window_s = time.perf_counter() - t0
        self.counters = {"steps": len(rows), "rows": rows,
                         "patches": sum(rows), "window_s": window_s}
        return {"window_s": window_s, "work": sum(rows),
                self.end_to_end: sum(rows) / window_s}

    def free(self) -> None:
        """Keep the checked steps' losses and the norms the check compares;
        drop the model, its optimizer and the pipeline."""
        self.prog = _norms([float(t.sum()) for _, _, t in self.checked],
                           self.first_grad, self.delta)
        del self.model, self.steps, self.first_grad, self.delta
        self.items = self.pipe = self.store = None

    # -- the check ----------------------------------------------------------

    def _reference_batches(self):
        """The checked steps' batches as the reference takes them: per
        shape run, the cloud, queries and ground truth loaded anew from the
        dataset, the sampler's rows and the run's draws."""
        dev = self.dev
        counts = list(self.sampler.shape_patch_count)
        offsets = np.cumsum([0] + counts)
        listing = self.root / self.ctx.workload["params"]["shape_list"]
        names = [ln.strip() for ln in listing.read_text().splitlines()
                 if ln.strip()]
        clouds, qpts, qdist = {}, {}, {}
        batches = []
        for key, chunk, _ in self.checked:
            shapes = np.searchsorted(offsets, chunk, side="right") - 1
            local = chunk - offsets[shapes]
            firsts = sorted(np.unique(shapes, return_index=True)[1])
            runs = []
            for r, si in enumerate(int(shapes[i]) for i in firsts):
                if si not in clouds:
                    name = names[si]
                    clouds[si] = ref_data.padded(
                        np.load(self.root / "04_pts" / f"{name}.xyz.npy"),
                        dev)
                    qpts[si] = np.load(self.root / "05_query_pts" /
                                       f"{name}.ply.npy")
                    qdist[si] = np.load(self.root / "05_query_dist" /
                                        f"{name}.ply.npy")
                sel = np.nonzero(shapes == si)[0]
                li = local[sel]
                pts, nv = clouds[si]
                runs.append({
                    "points": pts, "n_valid": nv,
                    "queries": torch.as_tensor(qpts[si][li], device=dev),
                    "gt": torch.as_tensor(qdist[si][li], device=dev),
                    "draws": self.checked_draws[key][r],
                    "rows": torch.as_tensor(sel, device=dev)})
            if len(runs) != len(self.checked_draws[key]):
                raise RuntimeError(f"step {key}: {len(runs)} runs, "
                                   f"{len(self.checked_draws[key])} draws")
            batches.append(runs)
        return batches

    def check(self, tf32: bool = False) -> list[tuple[str, float]]:
        """The compared numbers of the three checked steps against the
        reference's: the first step's loss, and by the median parameter the
        first gradient's norm and the parameters' change after the three
        (the later steps' losses and the worst parameter swing with
        round-off from seed to seed: PERF.md). With ``tf32`` the reference
        in TF32 stands in the program's place (the control)."""
        batches = self._reference_batches()
        weights = {k: v.to(self.dev) for k, v in self.weights.items()}
        want = _norms(*ref_train.run_steps(self.cfg, weights, batches))
        got = (_norms(*ref_train.run_steps(self.cfg, weights, batches,
                                           tf32=True))
               if tf32 else self.prog)
        loss = abs(got["losses"][0] - want["losses"][0]) / abs(
            want["losses"][0])
        return [("loss_step1_err", loss),
                ("grad_median_err",
                 leaf_gap(got["grad"], want["grad"], want["grad"])),
                ("delta_median_err",
                 leaf_gap(got["delta"], want["delta"], want["grad"]))]


def _norms(losses, grad, delta) -> dict:
    """Each step's loss and each parameter's first-gradient and change
    norms, as the check compares them."""
    def norms(d):
        return {k: float(torch.linalg.vector_norm(v.double()))
                for k, v in d.items()}
    return {"losses": losses, "grad": norms(grad), "delta": norms(delta)}


def leaf_gaps(got: dict, want: dict, grad: dict) -> dict:
    """Each parameter's gap between the program's norm and the reference's,
    over the larger of the reference's norm and the median parameter's;
    parameters whose reference first gradient is under a thousandth of the
    median parameter's are left out (they move by round-off alone)."""
    med_g = float(np.median(list(grad.values())))
    keep = [k for k in want if grad[k] >= 1e-3 * med_g]
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keep}


def leaf_gap(got: dict, want: dict, grad: dict) -> float:
    """The median of ``leaf_gaps``."""
    return float(np.median(list(leaf_gaps(got, want, grad).values())))
