"""Training driver (counterpart of ``points2surf_tpu/train/trainer.py``): the
train steps and the epoch loop.

One train step is the JAX package's: forward with batch statistics (running
statistics updated as flax does), the weighted losses, backward, then SGD
with momentum, ``t = g + momentum * t``, ``p -= lr(step) * t``, which is
what ``optax.sgd`` computes and what ``torch.optim.SGD`` with
``dampening=0`` computes. The learning rate is scaled by 0.1 at every
boundary ``step >= b`` (optax's ``piecewise_constant_schedule``, in
float32 as optax computes it). The fused step runs train-mode patch
extraction first.

On one CUDA device the step after extraction is a CUDA graph: the
forward, the losses, the backward and the SGD update, captured once per
batch signature, activation dtype and learning rate and then replayed, so
the host makes one launch where eager PyTorch makes some thousands
(:class:`TrainStep`). The same kernels run in the same order; the graph
only takes the launching of each off the host.

:class:`Trainer` is the epoch loop of the reference
(source/points_to_surf_train.py:167-534) on one device: the samplers and
the train and test pipelines (``data/``), the fused step for batches from
one shape and the plain step for mixed batches, test batches interleaved by
the fraction of the epoch done, TensorBoard scalars under the reference's
tag names, and checkpoints in the JAX package's layout
(``train/checkpoint.py``) every ``save_interval`` epochs plus log-spaced
snapshots, with the optimizer state (the reference drops it).

On one device, or on every rank of a ``torchrun`` launch (``parallel/``):
every rank runs the same seeded plan and draws, takes its contiguous rows
of each global batch and of its draws, and normalizes with the global
batch's statistics (``models/pointnet.py``); the step averages the ranks'
gradients of their mean losses over equal row counts (the ragged remainder
is dropped), which is the gradient of the global batch's loss. The logged
scalars are averaged over the ranks; rank 0 alone writes TensorBoard
scalars, checkpoints and the run's params.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from collections import deque

import numpy as np
import torch

from points2surf_tpu_torch.data.pipeline import PatchPipeline
from points2surf_tpu_torch.data.samplers import (
    RandomPatchSampler,
    SequentialShapeRandomPatchSampler,
)
from points2surf_tpu_torch.data.shapes import ShapeStore
from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.models import losses as L
from points2surf_tpu_torch.models.p2s import PointsToSurfModel
from points2surf_tpu_torch.models.pointnet import set_act_dtype
from points2surf_tpu_torch.models.weights import (
    sgd_state_from_checkpoint,
    sgd_state_to_checkpoint,
)
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_grad, pooled_tail_reductions)
from points2surf_tpu_torch.ops.patches import PatchConfig, extract_patches
from points2surf_tpu_torch.parallel import distributed, replicate, shard_batch
from points2surf_tpu_torch.train import checkpoint as ckpt
from points2surf_tpu_torch.utils import trace

# live CUDA graphs a TrainStep keeps for one activation dtype and learning
# rate (one per batch signature); steps of further signatures run eagerly
MAX_GRAPHS = 4
# the kernel launch counters a train step can move: a replay adds what its
# capture launched, so they count the kernels that ran
_LAUNCH_COUNTERS = ((pooled_tail_reductions, "launches"),
                    (pooled_tail_reductions, "launches_bf16"),
                    (pooled_tail_grad, "launches"))

GREEN = "\033[92m"
BLUE = "\033[94m"
ENDC = "\033[0m"


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
    """The model of the training options ``opt``: float32 activations, or
    bfloat16 with ``train_dtype=bfloat16`` (parameters, running statistics,
    losses and checkpoints stay float32 either way)."""
    dtype = (torch.bfloat16
             if getattr(opt, "train_dtype", "float32") == "bfloat16"
             else None)
    return PointsToSurfModel(
        net_size_max=opt.net_size,
        output_dim=pred_dim,
        use_point_stn=bool(opt.use_point_stn),
        use_feat_stn=bool(opt.use_feat_stn),
        sym_op=opt.sym_op,
        single_transformer=bool(opt.single_transformer),
        shared_transformation=bool(opt.shared_transformer),
        dtype=dtype,
    )


def f32_switch_epoch(opt) -> int:
    """The first epoch of precision annealing's float32 steps (with
    ``train_dtype=bfloat16``): ``nepoch - f32_finetune_epochs``, where -1
    stands for max(5, nepoch // 5)."""
    tail = int(getattr(opt, "f32_finetune_epochs", 0))
    if tail < 0:
        tail = max(5, opt.nepoch // 5)
    return opt.nepoch - tail


def learning_rate(step: int, lr: float, boundaries=()) -> float:
    """Piecewise-constant learning rate: ``lr`` times 0.1 for every
    boundary (in steps) with ``step >= boundary``, in float32 as optax's
    ``piecewise_constant_schedule`` computes it."""
    v = np.float32(lr)
    for b in boundaries:
        if step >= b:
            v = v * np.float32(0.1)
    return float(v)


class TrainStep:
    """The train, eval and fused train steps of one model and its SGD state.

    ``train_step`` is ``forward_loss``, ``backward`` and ``update`` in turn;
    the gradients stay in the parameters' ``.grad`` after it. Under a
    process group ``backward`` averages them over the data ranks (one
    collective), each data rank holding an equal share of the global batch.

    On a grid with a ``model`` axis (``parallel/mesh.make_mesh``) the model
    is partitioned first (``parallel/sharding.partition_params``, then this
    step's optimizer over its blocks): every model rank of a data rank takes
    the same rows and the same draws, the column blocks' gradients are
    complete on their rank (``models/pointnet._column_parallel``), and the
    mean over the data ranks covers blocks and replicated parameters alike.

    **CUDA graphs.** Where the batch is on a CUDA device and the process
    runs no data or model axis (their collectives stay eager),
    ``train_step`` replays a CUDA graph of itself: forward, losses,
    backward, update and metrics. A graph is keyed by the batch's keys,
    shapes and dtypes, the model's activation dtype and the step's learning
    rate (the rate is a constant of the captured update). A batch
    signature's first step at an activation dtype runs eagerly as its
    warm-up; a key's next step is captured and replayed, every later one
    replayed (so a new rate captures at once). The batch is copied into
    the graph's inputs, and the losses and metrics returned are copies of
    its outputs, so a later replay leaves them as they were. The graphs of
    one activation dtype and rate are kept, at most ``MAX_GRAPHS``,
    sharing one memory pool; a step of another dtype or rate drops them
    (the rate only falls as the step count grows), and ``load_sgd_state``
    drops them, since it replaces the momentum buffers they update. A CPU
    batch, a data or model axis, ``eval_step`` and keys beyond the cap run
    eagerly. Recorder:
    ``train.graph_captures``, ``train.graph_replays`` (the captured step's
    first run is a replay) and the span ``train.replay`` around the input
    copies and the replay; the device time of a replay's launches falls
    under ``train.replay``.
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
        self._graphs: dict = {}  # key -> _StepGraph, of one graph mode
        self._graph_mode = None  # (activation dtype, learning rate)
        self._warm: set = set()  # (signature, dtype) whose warm-up ran
        self._pool = None  # the graphs' memory pool

    def load_sgd_state(self, buffers: dict, count: int | None) -> None:
        """Momentum buffers under the ``state_dict`` names (see
        ``models.weights.sgd_state_from_checkpoint``) and the step count.
        Drops the step's CUDA graphs, which update the old buffers."""
        self._drop_graphs()
        for name, p in self.model.named_parameters():
            self.optimizer.state[p]["momentum_buffer"] = (
                buffers[name].to(device=p.device, dtype=p.dtype).clone())
        if count is not None:
            self.step = count

    def forward_loss(self, batch: dict):
        """Train-mode forward and the weighted losses: (losses, pred). The
        losses and metrics take a bf16 prediction in float32."""
        with trace.span("train.forward"):
            self.model.train()
            pred = self.model(batch)
            pred = pred.to(torch.promote_types(pred.dtype, torch.float32))
            return L.compute_loss(pred, batch, self.outputs,
                                  self.loss_weights, self.fixed_radius), pred

    def backward(self, losses) -> None:
        with trace.span("train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            torch.stack(losses).sum().backward()
            if distributed.data_size() > 1:
                grads = [p.grad for p in self.model.parameters()
                         if p.grad is not None]
                flat = distributed.mean_over_ranks_(
                    torch.cat([g.reshape(-1) for g in grads]))
                start = 0
                for g in grads:
                    g.copy_(flat[start:start + g.numel()].view_as(g))
                    start += g.numel()

    def update(self) -> None:
        with trace.span("train.update"):
            for group in self.optimizer.param_groups:
                group["lr"] = learning_rate(self.step, self.lr,
                                            self.boundaries)
            self.optimizer.step()
            self.step += 1

    def train_step(self, batch: dict):
        """One SGD step on ``batch``: (losses (n_losses,), metrics); a
        replay of the step's CUDA graph where one engages (class
        docstring)."""
        graph = self._graph_for(batch)
        if graph is None:
            return self._eager_step(batch)
        if not self.model.training:
            self.model.train()
        with trace.span("train.replay"):
            out = graph.replay(batch)
        trace.count("train.graph_replays")
        self.step += 1
        return out

    def graph_key(self, batch: dict) -> tuple:
        """The key of ``batch``'s graph: the batch's keys, shapes and
        dtypes, the model's activation dtype and the step's learning
        rate."""
        return (tuple((k, tuple(v.shape), v.dtype)
                      for k, v in sorted(batch.items())),
                getattr(self.model, "act_dtype", None),
                learning_rate(self.step, self.lr, self.boundaries))

    def _graph_for(self, batch: dict):
        """The graph to replay for ``batch``, captured now if this is its
        key's second step; None where the step runs eagerly."""
        if not graph_engages(batch):
            return None
        key = self.graph_key(batch)
        if key[1:] != self._graph_mode:
            self._drop_graphs()
            self._graph_mode = key[1:]
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        if key[:2] not in self._warm:  # the warm-up does not need the rate
            self._warm.add(key[:2])
            return None
        if len(self._graphs) >= MAX_GRAPHS:
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        step = self.step
        graph = _StepGraph(self, batch, self._pool)
        self.step = step  # update() counted the step it captured
        trace.count("train.graph_captures")
        self._graphs[key] = graph
        return graph

    def _drop_graphs(self) -> None:
        """Drop every graph, and their pool: a pool lives only while a
        graph holds it, so the next capture takes a new one."""
        self._graphs.clear()
        self._pool = None

    def _eager_step(self, batch: dict):
        losses, pred = self.forward_loss(batch)
        self.backward(losses)
        self.update()
        with torch.no_grad(), trace.span("train.metrics"):
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
        with trace.span("train.extract"):
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


def graph_engages(batch: dict) -> bool:
    """Whether a train step on ``batch`` runs as a CUDA graph: every tensor
    on a CUDA device, and no data or model axis (whose collectives stay
    eager)."""
    return (distributed.data_size() == 1 and distributed.model_size() == 1
            and all(v.device.type == "cuda" for v in batch.values()))


def _launch_counts() -> list:
    return [getattr(f, name) for f, name in _LAUNCH_COUNTERS]


class _StepGraph:
    """One train step captured as a CUDA graph in the memory pool ``pool``:
    its inputs (copies of the batch's tensors, outside the pool), its
    outputs, the gradients its backward writes and the kernel launches it
    holds."""

    def __init__(self, steps: TrainStep, batch: dict, pool):
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        for k, v in self.inputs.items():
            v.copy_(batch[k])
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.losses, self.metrics = steps._eager_step(self.inputs)
        self.launches = [b - a for a, b in zip(before, _launch_counts())]
        for (f, name), n in zip(_LAUNCH_COUNTERS, self.launches):
            setattr(f, name, getattr(f, name) - n)  # nothing ran yet
        self.grads = [(p, p.grad) for p in steps.model.parameters()]

    def replay(self, batch: dict):
        """The step on ``batch``: (losses, metrics), copies of the graph's
        outputs. The parameters' ``.grad`` are the graph's gradients."""
        for k, v in self.inputs.items():
            v.copy_(batch[k])
        self.graph.replay()
        for (f, name), n in zip(_LAUNCH_COUNTERS, self.launches):
            setattr(f, name, getattr(f, name) + n)
        for p, g in self.grads:
            if p.grad is not g:
                p.grad = g
        return (self.losses.clone(),
                {k: v.clone() for k, v in self.metrics.items()})


def make_train_step(model: torch.nn.Module, outputs, **kwargs) -> TrainStep:
    """Steps of ``model``; keyword arguments as :class:`TrainStep`."""
    return TrainStep(model, outputs, **kwargs)


def _lookahead(it):
    """Yield (item, next_item) pairs; next_item is None at the end."""
    prev = None
    have_prev = False
    for item in it:
        if have_prev:
            yield prev, item
        prev = item
        have_prev = True
    if have_prev:
        yield prev, None


class Trainer:
    """The epoch loop of the training options ``opt`` (``cli/train_args``)
    on ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, opt, log_writer=None, device="cuda"):
        self.opt = opt
        self.device = require_cuda(device)
        self.pred_dim, self.output_names, self.loss_weights = output_spec(
            opt.outputs
        )
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(opt.seed)
            self.model = build_model(opt, self.pred_dim).to(self.device)
        self.fixed_radius = opt.patch_radius > 0.0
        self.log_writer = log_writer if distributed.is_main_process() else None

        self.patch_cfg = PatchConfig(
            points_per_patch=opt.points_per_patch,
            patch_radius=opt.patch_radius,
            sub_sample_size=opt.sub_sample_size,
            uniform_subsample=bool(opt.uniform_subsample),
            fixed_subsample=bool(opt.fixed_subsample),
        )
        self.train_store, self.test_store = (
            ShapeStore(opt.indir, name, with_query=True,
                       cache_capacity=opt.cache_capacity, device=self.device)
            for name in (opt.trainset, opt.testset))
        # the reference augments train AND its interleaved test batches
        # (any non-reconstruction __getitem__, data_loader.py:381-393)
        self.train_pipe = PatchPipeline(
            self.train_store, self.patch_cfg, augment=True, seed=opt.seed
        )
        self.test_pipe = PatchPipeline(
            self.test_store, self.patch_cfg, augment=True, seed=opt.seed + 1
        )
        self.train_sampler = self._make_sampler(self.train_store)
        self.test_sampler = self._make_sampler(self.test_store)

        self.steps_per_epoch = max(
            1, math.ceil(len(self.train_sampler) / opt.batchSize)
        )
        # one boundary per distinct epoch, as optax's dict of boundaries
        self.boundaries = tuple(dict.fromkeys(
            int(e) * self.steps_per_epoch for e in opt.scheduler_steps))
        self.steps = TrainStep(
            self.model, opt.outputs, lr=opt.lr, momentum=opt.momentum,
            boundaries=self.boundaries, patch_cfg=self.patch_cfg,
            fixed_radius=self.fixed_radius,
        )
        self.global_step = 0
        self.start_epoch = 0
        if getattr(opt, "refine", ""):
            print(f"Refining weights from {opt.refine}")
            flat = ckpt.load_state(opt.refine, self.state_dict().keys())
            ckpt.load_model_state(self.model, flat)
            self.steps.load_sgd_state(*sgd_state_from_checkpoint(flat))
            self.start_epoch = ckpt.epoch_from_filename(opt.refine)
            self.global_step = self.start_epoch * self.steps_per_epoch
            if self.start_epoch:
                print(f"Continuing training from epoch {self.start_epoch}")
        replicate(self.model)

    def _make_sampler(self, store):
        opt = self.opt
        if opt.training_order == "random":
            cls = RandomPatchSampler
        elif opt.training_order == "random_shape_consecutive":
            cls = SequentialShapeRandomPatchSampler
        else:
            raise ValueError(f"Unknown training order: {opt.training_order}")
        return cls(store.shape_patch_count, opt.patches_per_shape,
                   seed=opt.seed, identical_epochs=bool(opt.identical_epochs))

    def state_dict(self) -> dict:
        """The train state as checkpoint entries (JAX layout): parameters,
        batch statistics, the momentum trace and the step count."""
        state = self.steps.optimizer.state
        buffers = {
            name: state[p]["momentum_buffer"]
            if "momentum_buffer" in state.get(p, {}) else torch.zeros_like(p)
            for name, p in self.model.named_parameters()
        }
        return (ckpt.model_state(self.model)
                | sgd_state_to_checkpoint(buffers, self.steps.step))

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    # -- steps -------------------------------------------------------------

    def _train_single(self, si: int, local_inds, gt):
        """Fused step on one shape's queries: extraction and the step. Each
        rank takes its rows of the queries and of the global batch's draws
        (every rank draws the whole batch); None when the batch leaves the
        ranks no rows."""
        pts_dev, n_valid = self.train_store.device_points(si)
        shape = self.train_store.get(si)
        lo, hi = distributed.rank_rows(len(local_inds))
        if hi == lo:
            return None  # a ragged tail smaller than the world
        small = self.train_pipe.small_cloud(n_valid)
        draws = self.train_pipe.draws((hi - lo) * distributed.data_size(),
                                      pts_dev.shape[0], small,
                                      n_valid=n_valid)
        if distributed.data_size() > 1:
            draws = draws.rows(lo, hi, chunk=self.patch_cfg.query_chunk)
        with trace.blocking(self.device, 2):
            q = torch.from_numpy(shape.query_pts[local_inds[lo:hi]]).to(
                self.device)
            gt = torch.from_numpy(gt[lo:hi]).to(self.device)
        return self.steps.train_step_fused(pts_dev, q, n_valid, gt, draws,
                                           small_cloud=small)

    # -- logging -----------------------------------------------------------

    def _log(self, prefix, train, epoch, batchind, fraction_done, num_batch,
             loss_list, metrics):
        """Fetch and log one step's scalars: the losses and metrics are
        packed into one tensor, averaged over the ranks and copied to the
        host once; rank 0 logs them."""
        opt = self.opt
        mkeys = tuple(sorted(metrics))
        flat = distributed.mean_over_ranks_(torch.cat(
            [loss_list.reshape(-1).float()]
            + ([torch.stack([metrics[k].float() for k in mkeys])]
               if mkeys else [])
        ))
        with trace.blocking(flat.device):
            flat_np = flat.cpu().numpy()
        n_loss = flat_np.shape[0] - len(mkeys)
        if not distributed.is_main_process():
            return
        loss_np = flat_np[:n_loss]
        metrics = {k: flat_np[n_loss + i] for i, k in enumerate(mkeys)}
        loss_sum = float(loss_np.sum())
        current_step = (epoch + fraction_done) * num_batch * opt.batchSize
        w = self.log_writer
        if w is not None:
            tag = "train" if train else "eval"
            w.add_scalar(f"loss/{tag}/total", loss_sum, current_step)
            if len(loss_np) > 1:
                for wi, v in enumerate(loss_np):
                    w.add_scalar(
                        f"loss/{tag}/comp_{self.output_names[wi]}",
                        float(v),
                        current_step,
                    )
            for k in ("abs_dist_rms", "accuracy", "precision", "recall",
                      "f1_score"):
                if k in metrics:
                    v = float(metrics[k])
                    w.add_scalar(
                        f"metrics/{tag}/{k}",
                        0.0 if math.isnan(v) else v,
                        current_step,
                    )
        if batchind % opt.debug_interval == 0:
            rmse = float(metrics.get("abs_dist_rms", float("nan")))
            f1 = float(metrics.get("f1_score", float("nan")))
            print(
                f"[{opt.name} {epoch}: {batchind}/{num_batch - 1}] {prefix} "
                f"loss: {loss_sum:+.2f}, rmse: {rmse:+.2f}, f1: {f1:+.2f}"
            )

    # -- main loop ---------------------------------------------------------

    def train(self):
        opt = self.opt
        model_filename = os.path.join(opt.outdir, f"{opt.name}_model.npz")
        main = distributed.is_main_process()
        if main:
            os.makedirs(opt.outdir, exist_ok=True)
            ckpt.save_params_namespace(
                os.path.join(opt.outdir, f"{opt.name}_params.json"), opt
            )
            with open(
                os.path.join(opt.outdir, f"{opt.name}_description.txt"), "w"
            ) as f:
                print(opt.desc, file=f)

        train_num_batch = self.steps_per_epoch
        test_num_batch = max(
            1, math.ceil(len(self.test_sampler) / opt.batchSize)
        )

        # opt-in trace: P2S_PROFILE_DIR receives a torch.profiler trace of
        # global steps 5-10 (cut short if the run ends inside them) and the
        # port's spans and counters of the same steps
        profile_dir = os.environ.get("P2S_PROFILE_DIR", "")
        profile_window = (5, 10) if profile_dir else None
        prof = None

        # deferred logging: fetching a step's scalars at once would wait for
        # the device every step; a few steps of lag keep the queue full
        log_lag = 4
        pending_logs: deque = deque()

        def flush_logs(limit=None):
            while pending_logs and (
                limit is None or len(pending_logs) > limit
            ):
                self._log(*pending_logs.popleft())

        # precision annealing: with train_dtype bfloat16 the final epochs
        # run float32 activations; parameters and SGD state are float32
        # either way, so only the model's activation dtype switches
        switch_epoch = f32_switch_epoch(opt)
        for epoch in range(self.start_epoch, opt.nepoch):
            t_epoch = time.time()
            if self.model.act_dtype is not None and epoch >= switch_epoch:
                print(f"precision annealing: switching to float32 steps at "
                      f"epoch {epoch}")
                set_act_dtype(self.model, None)
            if opt.identical_epochs:
                self.train_pipe.reset()
                self.test_pipe.reset()
            test_iter = self.test_pipe.batches(
                iter(self.test_sampler), opt.batchSize
            )
            test_batchind = -1
            test_fraction_done = 0.0

            for batchind, (item, next_item) in enumerate(
                _lookahead(
                    self.train_pipe.plan(
                        iter(self.train_sampler), opt.batchSize
                    )
                )
            ):
                if profile_window is not None:
                    if self.global_step == profile_window[0]:
                        prof = _start_profile(self.device)
                    elif self.global_step == profile_window[1] and prof:
                        _stop_profile(prof, profile_dir)
                        prof, profile_window = None, None
                if item[0] == "single":
                    _, si, local_inds, gt = item
                    out = self._train_single(si, local_inds, gt)
                else:
                    batch = shard_batch(item[1])
                    out = (self.steps.train_step(batch)
                           if len(batch["imp_surf_ms"]) else None)
                if out is None:
                    continue  # a ragged tail smaller than the world
                loss_list, metrics = out
                # upload the NEXT shape's cloud while this step's work is
                # still queued on the device (the sampler order is known)
                if (
                    next_item is not None
                    and next_item[0] == "single"
                    and (item[0] != "single" or next_item[1] != item[1])
                ):
                    self.train_store.device_points(next_item[1])
                self.global_step += 1
                fraction_done = (batchind + 1) / train_num_batch
                # --log_every_batch restores the reference's TensorBoard
                # cadence (one scalar point per train batch,
                # points_to_surf_train.py:474-478); the default logs at the
                # --debug_interval cadence
                if (
                    getattr(opt, "log_every_batch", 0)
                    or batchind % opt.debug_interval == 0
                    or batchind == train_num_batch - 1
                ):
                    pending_logs.append((
                        GREEN + "train" + ENDC, True, epoch, batchind,
                        fraction_done, train_num_batch, loss_list, metrics,
                    ))
                    flush_logs(limit=log_lag)

                # interleave test batches paced by train progress (:480-509)
                while (
                    test_fraction_done <= fraction_done
                    and test_batchind + 1 < test_num_batch
                ):
                    tb = next(test_iter, None)
                    if tb is None:
                        break
                    test_batchind += 1
                    test_fraction_done = (test_batchind + 1) / test_num_batch
                    tb = shard_batch(tb)
                    if not len(tb["imp_surf_ms"]):
                        continue
                    loss_t, metrics_t = self.steps.eval_step(tb)
                    pending_logs.append((
                        BLUE + "test" + ENDC, False, epoch, test_batchind,
                        test_fraction_done, train_num_batch, loss_t, metrics_t,
                    ))
                    flush_logs(limit=log_lag)

            flush_logs()  # drain deferred scalars before checkpointing
            # rank 0 writes: the parameters are the same on every rank
            if main and (epoch % opt.save_interval == 0
                         or epoch == opt.nepoch - 1):
                ckpt.save_state(model_filename, self.state_dict())
            if main and ckpt.is_snapshot_epoch(epoch, opt.nepoch):
                ckpt.save_state(
                    os.path.join(opt.outdir, f"{opt.name}_model_{epoch}.npz"),
                    self.state_dict(),
                )

            lr_now = learning_rate(self.global_step, opt.lr, self.boundaries)
            if self.log_writer is not None:
                self.log_writer.add_scalar(
                    "LR", lr_now,
                    (epoch + 1) * train_num_batch * opt.batchSize - 1,
                )
                self.log_writer.flush()
            print(
                f"epoch {epoch} done in {time.time() - t_epoch:.1f}s "
                f"(lr {lr_now:g})"
            )
        if prof is not None:  # the run ended inside the window
            _stop_profile(prof, profile_dir)


def _start_profile(device: torch.device):
    """(the open window, the profiler, the dict the recorder fills when the
    window closes)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    window = contextlib.ExitStack()
    prof = window.enter_context(profile(activities=acts))
    program = window.enter_context(trace.recording())
    return window, prof, program


def _stop_profile(opened, profile_dir: str) -> None:
    window, prof, program = opened
    window.close()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "train_steps_5_10.json")
    prof.export_chrome_trace(path)
    spans = os.path.join(profile_dir, "program_spans_5_10.json")
    with open(spans, "w") as f:
        json.dump(program, f)
    print(f"profiler trace of steps 5-10 -> {path}, spans -> {spans}")
