"""The train step as a CUDA graph (``train/trainer.TrainStep``).

CPU: the rule that decides when a step is a graph (a CPU batch, a data or
model axis: eager), the graph's key (batch signature, activation dtype,
learning rate), the cap on live graphs, ``load_sgd_state`` dropping them
(capture and replay stood in for by eager steps), and the QSTN's identity
quaternion made on the device, bit for bit as the host constant gave it.

``cuda``-marked, at net 1024 with the ``p2s_vanilla`` and ``p2s_max``
model flags: six steps of two batch sizes across one learning-rate
boundary, fused and pipeline batches, graphed against eager, bit for bit
in losses, metrics, parameters, momentum buffers and BN running
statistics; the counters and the kernels' launch counts.
"""

import os
import types

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.data.pipeline import PatchPipeline
from points2surf_tpu_torch.data.shapes import ShapeStore
from points2surf_tpu_torch.models.p2s import PointsToSurfModel
from points2surf_tpu_torch.models.pointnet import QSTN, set_act_dtype
from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_grad, pooled_tail_reductions)
from points2surf_tpu_torch.parallel import distributed
from points2surf_tpu_torch.train import trainer
from points2surf_tpu_torch.utils import trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
GRAPH_COUNTERS = ("train.graph_captures", "train.graph_replays")


def _batch(b: int, device="cpu", k: int = 16, s: int = 24) -> dict:
    """A train batch of ``b`` rows with the keys extraction gives."""
    g = torch.Generator().manual_seed(b)
    gt = (torch.rand(b, generator=g) - 0.5) * 0.1
    out = {"patch_pts_ps": torch.randn(b, k, 3, generator=g) * 0.5,
           "patch_radius_ms": torch.rand(b, generator=g) + 0.05,
           "pts_sub_sample_ms": torch.randn(b, s, 3, generator=g) * 0.5,
           "imp_surf_query_point_ms": torch.randn(b, 3, generator=g) * 0.1,
           "imp_surf_query_point_ps": torch.zeros(b, 3),
           "patch_pts_ids": torch.randint(0, 100, (b, k), generator=g),
           "imp_surf_ms": gt, "imp_surf_magnitude_ms": gt.abs(),
           "imp_surf_dist_sign_ms": (gt >= 0).float()}
    return {k: v.to(device) for k, v in out.items()}


def _steps(net=32, **kw):
    torch.manual_seed(0)
    model = PointsToSurfModel(net_size_max=net, output_dim=2)
    return trainer.TrainStep(model, OUTPUTS, **kw)


def _graph_records(got) -> tuple:
    return ({k: v for k, v in got["counters"].items()
             if k in GRAPH_COUNTERS},
            [s["name"] for s in got["spans"] if s["name"] == "train.replay"])


# -- on the CPU ---------------------------------------------------------------


def test_cpu_batch_runs_eagerly_and_counts_no_graph():
    steps = _steps()
    batch = _batch(24)
    with trace.recording() as got:
        for _ in range(3):
            steps.train_step(batch)
    assert _graph_records(got) == ({}, [])
    assert not steps._graphs and steps.step == 3
    assert [s["name"] for s in got["spans"]].count("train.backward") == 3


@pytest.mark.parametrize("axis", ["data_size", "model_size"])
def test_data_or_model_axis_runs_eagerly(monkeypatch, axis):
    """A batch on a CUDA device (stood in for by tensors' devices: this
    machine may have no card) is a graph with one rank, and eager on a data
    or model axis, before any key is formed or counted."""
    fake = {"x": types.SimpleNamespace(device=torch.device("cuda", 0))}
    assert trainer.graph_engages(fake)
    assert not trainer.graph_engages(_batch(4))
    monkeypatch.setattr(distributed, axis, lambda: 2)
    assert not trainer.graph_engages(fake)
    steps = _steps()
    with trace.recording() as got:
        assert steps._graph_for(fake) is None
    assert got["counters"] == {} and not steps._warm


def test_graph_key_changes_with_shape_dtype_and_rate():
    steps = _steps(boundaries=(3,))
    key = steps.graph_key(_batch(24))
    # the values and the keys' order are not part of it
    other = dict(reversed(list(_batch(24, k=16).items())))
    other["imp_surf_ms"] = other["imp_surf_ms"] + 1.0
    assert steps.graph_key(other) == key
    assert steps.graph_key(_batch(25)) != key
    assert steps.graph_key(_batch(24, k=17)) != key
    ids = dict(_batch(24), patch_pts_ids=_batch(24)["patch_pts_ids"].int())
    assert steps.graph_key(ids) != key
    set_act_dtype(steps.model, torch.bfloat16)
    assert steps.graph_key(_batch(24)) != key
    set_act_dtype(steps.model, None)
    assert steps.graph_key(_batch(24)) == key
    steps.step = 3  # the boundary: lr 0.01 -> 0.001
    assert steps.graph_key(_batch(24)) != key
    assert steps.graph_key(_batch(24))[2] == trainer.learning_rate(
        3, 0.01, (3,))


class _FakeGraph:
    """A capture and its replays as eager steps (no card here)."""

    made = 0

    def __init__(self, steps, batch, pool):
        type(self).made += 1
        self.steps = steps

    def replay(self, batch):
        step = self.steps.step
        out = self.steps._eager_step(batch)
        self.steps.step = step  # train_step counts the replayed step
        return out


@pytest.fixture
def fake_graphs(monkeypatch):
    _FakeGraph.made = 0
    monkeypatch.setattr(trainer, "graph_engages", lambda batch: True)
    monkeypatch.setattr(trainer, "_StepGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    return _FakeGraph


def test_warm_up_capture_replay_and_the_cap(fake_graphs):
    """A key's first step is eager, its second a capture and replay, later
    ones replays; past ``MAX_GRAPHS`` live graphs steps run eagerly."""
    steps = _steps()
    sizes = list(range(20, 20 + trainer.MAX_GRAPHS + 1))
    with trace.recording() as got:
        for b in sizes:
            for _ in range(3):
                steps.train_step(_batch(b))
    cap = trainer.MAX_GRAPHS
    assert len(steps._graphs) == cap == fake_graphs.made
    assert got["counters"]["train.graph_captures"] == cap
    assert got["counters"]["train.graph_replays"] == 2 * cap
    names = [s["name"] for s in got["spans"]]
    assert names.count("train.replay") == 2 * cap
    # outside a replay: each key's warm-up, and every step of the key past
    # the cap
    eager = [s for s in got["spans"]
             if s["name"] == "train.backward" and s["parent"] == 0]
    assert len(eager) == cap + 3
    assert steps.step == 3 * len(sizes)


def test_rate_or_dtype_change_and_load_sgd_state_drop_graphs(fake_graphs):
    steps = _steps(boundaries=(3,))
    for _ in range(3):  # warm-up, capture, replay
        steps.train_step(_batch(24))
    assert len(steps._graphs) == 1 and fake_graphs.made == 1
    # the boundary: a new rate drops the graphs and captures anew at once
    # (a warm-up does not depend on the rate)
    steps.train_step(_batch(24))
    assert fake_graphs.made == 2 and len(steps._graphs) == 1
    assert next(iter(steps._graphs))[2] == trainer.learning_rate(
        3, 0.01, (3,))
    set_act_dtype(steps.model, torch.bfloat16)  # a warm-up of its own
    steps.train_step(_batch(24))
    assert fake_graphs.made == 2 and not steps._graphs
    set_act_dtype(steps.model, None)
    steps.train_step(_batch(24))
    assert fake_graphs.made == 3 and len(steps._graphs) == 1
    bufs = {n: torch.zeros_like(p)
            for n, p in steps.model.named_parameters()}
    steps.load_sgd_state(bufs, None)
    assert not steps._graphs and steps.step == 6
    steps.train_step(_batch(24))
    assert fake_graphs.made == 4 and steps.step == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qstn_identity_bit_identical_to_the_host_constant(monkeypatch,
                                                          dtype):
    h = torch.tensor([[0.25, -0.0, 0.0, -1.5], [-0.0, 0.0, -0.0, 0.0],
                      [-1.0, 3.0, -0.0, 1e-30], [2.0, -2.0, 0.5, -0.125]],
                     dtype=dtype)
    stn = QSTN(32, dtype=None if dtype == torch.float32 else dtype)
    monkeypatch.setattr(stn, "trunk", lambda x: h)
    rot, quat = stn(torch.zeros(4, 8, 3))
    want = h + torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype)
    assert quat.dtype == dtype
    assert torch.equal(quat.view(torch.int16), want.view(torch.int16))
    assert torch.equal(rot, geometry.quat_to_rotmat(want))


# -- on the card --------------------------------------------------------------

MODELS = {
    "p2s_vanilla": (dict(use_point_stn=True, shared_transformation=True),
                    dict(uniform_subsample=False), 5),
    "p2s_max": (dict(use_point_stn=False), dict(uniform_subsample=True), 4),
}
NET, PATCH, SUB = 1024, 300, 1000
B1, B2 = 512, 384
BOUNDARY = 5  # the sixth step runs at a tenth of the rate


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _plan(dev, cfg):
    """The six steps' inputs: fused runs of one shape (cloud, queries, gt,
    draws) and pipeline batches across the two train shapes. Sizes B1, B1
    (pipeline), B1, B2, B2, B1 (fused unless said)."""
    store = ShapeStore(ABC, "trainset.txt", with_query=True, device=dev)
    pipe = PatchPipeline(store, cfg, augment=True, seed=3)
    rng = np.random.RandomState(7)
    counts = store.shape_patch_count

    def fused(b):
        pts, nv = store.device_points(0)
        shape = store.get(0)
        li = rng.choice(counts[0], b, replace=False)
        q = torch.from_numpy(shape.query_pts[li]).to(dev)
        gt = torch.from_numpy(shape.query_dist[li].astype(np.float32)).to(dev)
        draws = pipe.draws(b, pts.shape[0], pipe.small_cloud(nv), n_valid=nv)
        return ("fused", (pts, q, nv, gt, draws))

    def mixed(b):
        idx = np.concatenate([rng.choice(counts[0], b // 2, replace=False),
                              counts[0] + rng.choice(counts[1], b - b // 2,
                                                     replace=False)])
        kind, batch = next(pipe.plan(idx, b + 1))  # b + 1: never "single"
        assert kind == "mixed"
        return ("pipeline", batch)

    return [fused(B1), mixed(B1), fused(B1), fused(B2), mixed(B2),
            fused(B1)]


def _run(dev, model_kw, cfg, plan):
    torch.manual_seed(0)
    model = PointsToSurfModel(net_size_max=NET, output_dim=2,
                              **model_kw).to(dev)
    steps = trainer.TrainStep(model, OUTPUTS, lr=0.01, momentum=0.9,
                              boundaries=(BOUNDARY,), patch_cfg=cfg)
    outs, first = [], None
    launches = (pooled_tail_reductions.launches, pooled_tail_grad.launches)
    with trace.recording() as got:
        for kind, args in plan:
            out = (steps.train_step_fused(*args) if kind == "fused"
                   else steps.train_step(args))
            outs.append(out)
            if first is None:
                torch.cuda.synchronize()
                first = out[0].clone()
    torch.cuda.synchronize()
    launched = (pooled_tail_reductions.launches - launches[0],
                pooled_tail_grad.launches - launches[1])
    state = {k: v.clone() for k, v in model.state_dict().items()}
    momentum = {n: steps.optimizer.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters()}
    return outs, first, got, launched, state, momentum


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graphed_steps_equal_eager_bit_for_bit(cuda_device, monkeypatch,
                                               name):
    model_kw, cfg_kw, tails = MODELS[name]
    cfg = tp.PatchConfig(points_per_patch=PATCH, sub_sample_size=SUB,
                         **cfg_kw)
    plan = _plan(cuda_device, cfg)
    graphed = _run(cuda_device, model_kw, cfg, plan)
    with monkeypatch.context() as m:
        m.setattr(trainer, "graph_engages", lambda batch: False)
        eager = _run(cuda_device, model_kw, cfg, plan)
    (g_out, g_first, g_got, g_launched, g_state, g_mom) = graphed
    (e_out, _, e_got, e_launched, e_state, e_mom) = eager
    for (gl, gm), (el, em) in zip(g_out, e_out):
        assert torch.equal(_bits(gl), _bits(el))
        assert gm.keys() == em.keys()
        for k in gm:
            assert torch.equal(_bits(gm[k]), _bits(em[k])), k
    # the first step's losses, as they read before the later replays
    assert torch.equal(_bits(g_out[0][0]), _bits(g_first))
    for k in e_state:
        assert torch.equal(_bits(g_state[k]), _bits(e_state[k])), k
    for k in e_mom:
        assert torch.equal(_bits(g_mom[k]), _bits(e_mom[k])), k
    # keys: B1 warm-up, the pipeline B1 captured (one key with the fused
    # B1), B1 replayed, B2 warm-up, B2 captured, B1 at the new rate
    # captured at once
    assert {k: g_got["counters"].get(k) for k in GRAPH_COUNTERS} == {
        "train.graph_captures": 3, "train.graph_replays": 4}
    assert _graph_records(e_got) == ({}, [])
    assert g_launched == e_launched == (6 * tails, 6 * tails)
