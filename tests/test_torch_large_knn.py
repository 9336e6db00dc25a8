"""p2s_large_kNN's variant of the port against the benchmark's plain
reference (``p2s_bench/reference``) on the CPU, at a small size that keeps
the variant's shape: a point STN inside the global encoder whose rotation
is applied to the patch too (``shared_transformation`` false), and patches
larger than the sub-sample (net 32, k 40, S 32, a 2,000-point cloud).

Held: the extraction's ids outside the rows whose selection rounding decides
(the reference's ``TIE``), on the tile path and on the dense path; the eval
query's signed distances; one train step's losses and gradients, as the
benchmark's training check holds them; the extraction's slot counters, and
outputs bit-identical with the recorder on and off.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "p2s_bench") not in sys.path:
    sys.path.append(str(ROOT / "p2s_bench"))

from reference import data as ref_data  # noqa: E402
from reference import model as ref_model  # noqa: E402
from reference import train as ref_train  # noqa: E402
from traffic.train import leaf_gap  # noqa: E402

from points2surf_tpu_torch.infer.query import make_sdf_query_fn  # noqa: E402
from points2surf_tpu_torch.models.p2s import PointsToSurfModel  # noqa: E402
from points2surf_tpu_torch.ops.patches import (  # noqa: E402
    PatchConfig, SubsampleDraws, TrainDraws, extract_patches)
from points2surf_tpu_torch.train.trainer import TrainStep  # noqa: E402
from points2surf_tpu_torch.utils import trace  # noqa: E402

K, SUB, NET = 40, 32, 32
N_CLOUD, N_PAD, B = 2000, 2048, 128
SHAPE = "00994122_57d9d4755722f9d2d7436f0a_trimesh_000"
# as the recon cell leaves out rows whose sign logit is this near 0
SIGN_TIE = 1e-4
# tile sizes at which the 2,000-point cloud has tiles at all (n > 2 M):
# TILES certifies every tile of the test's batch, FALLBACK certifies none
TILES = dict(tile_queries=32, tile_candidates=1000)
FALLBACK = dict(tile_queries=32, tile_candidates=48)


def _cfg() -> dict:
    cfg = json.loads((ROOT / "p2s_bench/configs/p2s_large_kNN.json")
                     .read_text())
    cfg["model"]["net_size"] = NET
    cfg["patch"].update(points_per_patch=K, sub_sample_size=SUB)
    return cfg


CFG = _cfg()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """(N_PAD, 3) cloud, its valid count, and B queries near a patch of its
    surface (spatially coherent, as a grid's near-surface batch is)."""
    pts = np.load(ROOT / "datasets/abc_minimal/04_pts" / f"{SHAPE}.xyz.npy")
    rng = np.random.RandomState(0)
    pts = pts[rng.choice(len(pts), N_CLOUD, replace=False), :3]
    points = torch.zeros((N_PAD, 3), dtype=torch.float32)
    points[:N_CLOUD] = torch.as_tensor(pts, dtype=torch.float32)
    near = np.argsort(np.linalg.norm(pts - pts[0], axis=1))[:B]
    q = pts[near] + rng.normal(0.0, 0.01, (B, 3))
    return points, N_CLOUD, torch.as_tensor(q, dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(20160)
    return ref_model.seeded_weights(ref_model.P2S(CFG["model"]), gen)


@pytest.fixture(scope="module")
def turning(weights):
    """The weights with the global encoder's point STN at full scale: its
    near-identity start turns the patch by ~1e-3 rad, which moves the
    distances less than the comparison's limit; at full scale a patch left
    unturned reads ~1e-4."""
    return {k: v * 100.0 if k.startswith("feat_global.stn1.fc3") else v
            for k, v in weights.items()}


def _port_model(weights):
    m = CFG["model"]
    model = PointsToSurfModel(
        net_size_max=m["net_size"], output_dim=m["output_dim"],
        use_point_stn=m["use_point_stn"], use_feat_stn=m["use_feat_stn"],
        sym_op=m["sym_op"], single_transformer=m["single_transformer"],
        shared_transformation=m["shared_transformation"])
    model.load_state_dict(weights, strict=True)
    return model


def _patch_cfg(depth: int, **tiles) -> PatchConfig:
    p = CFG["patch"]
    return PatchConfig(points_per_patch=K, patch_radius=p["patch_radius"],
                       sub_sample_size=SUB,
                       uniform_subsample=p["uniform_subsample"],
                       fixed_subsample=p["fixed_subsample"],
                       subsample_candidates=depth, **tiles)


def _draws(points, nv, b, depth, train, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return ref_data.make_draws(gen, b, points.shape[0], nv, CFG["patch"],
                               depth, train=train)


def _eval_draws(d) -> SubsampleDraws:
    return SubsampleDraws(d["offset"], d["logu"], ids=d["ids"])


def _reference_ids(points, nv, q):
    d2 = torch.where(torch.arange(len(points))[None, :] < nv,
                     ref_data.sqdist(q, points, False), float("inf"))
    return torch.topk(d2, K, dim=1, largest=False)[1]


def _extract(points, nv, q, d, tiles, coherent=True):
    depth = CFG["eval"]["subsample_candidates"]
    return extract_patches(points, q, nv, _eval_draws(d),
                           cfg=_patch_cfg(depth, **tiles), coherent=coherent)


PATHS = {"tiles": (TILES, True), "fallback": (FALLBACK, True),
         "dense": (TILES, False)}


@pytest.mark.parametrize("path", ["tiles", "fallback", "dense"])
def test_extraction_matches_reference(cloud, path):
    points, nv, q = cloud
    tiles, coherent = PATHS[path]
    depth = CFG["eval"]["subsample_candidates"]
    d = _draws(points, nv, B, depth, False)
    with trace.recording() as got:
        batch = _extract(points, nv, q, d, tiles, coherent)
    c = got["counters"]
    assert c.get("extract.tiled", 0) == int(coherent)
    assert c.get("extract.fallback", 0) == int(path == "fallback")
    _, radius, _, _, tie = ref_data.patches(
        points, nv, q, d, CFG["patch"], depth, train=False, ties=True)
    assert int(torch.count_nonzero(tie)) < B // 4
    sure = ~tie
    want = torch.sort(_reference_ids(points, nv, q), dim=1)[0]
    ids = torch.sort(batch["patch_pts_ids"], dim=1)[0]
    assert torch.equal(ids[sure], want[sure])
    torch.testing.assert_close(batch["patch_radius_ms"][sure], radius[sure],
                               rtol=1e-6, atol=0.0)


def _reference_sdf(weights, points, nv, q, d):
    ref = ref_model.P2S(CFG["model"]).eval()
    ref.load_state_dict(weights)
    depth = CFG["eval"]["subsample_candidates"]
    with torch.no_grad():
        patch_ps, radius, sub, qm, tie = ref_data.patches(
            points, nv, q, d, CFG["patch"], depth, train=False, ties=True)
        pred = ref(patch_ps, sub, qm)
    sure = ~tie & (pred[:, 1].abs()
                   >= SIGN_TIE * torch.median(pred[:, 1].abs()))
    return ref_data.signed_distance(pred, radius), radius, sure


@pytest.mark.parametrize("path", ["tiles", "dense"])
def test_eval_query_matches_reference(cloud, turning, path):
    points, nv, q = cloud
    tiles, coherent = PATHS[path]
    depth = CFG["eval"]["subsample_candidates"]
    d = _draws(points, nv, B, depth, False)
    fn = make_sdf_query_fn(_port_model(turning), tuple(CFG["outputs"]),
                           _patch_cfg(depth, **tiles), fixed_radius=False,
                           coherent=coherent)
    got = fn(points, q, nv, _eval_draws(d))
    want, radius, sure = _reference_sdf(turning, points, nv, q, d)
    assert int(torch.count_nonzero(sure)) > 3 * B // 4
    err = torch.abs(got[sure] - want[sure]) / radius[sure]
    assert float(err.max()) <= 1e-5


def test_train_step_matches_reference(cloud, weights):
    """One SGD step of the port's ``TrainStep`` (extraction inside the step)
    against ``reference/train.py``: the loss within 5e-6 relative, and the
    median parameter's first-gradient norm within 1.5e-3, the limits of the
    benchmark's training cells."""
    points, nv, q = cloud
    b = 32
    q = q[:b]
    gt = torch.as_tensor(np.random.RandomState(1).normal(0.0, 0.02, b),
                         dtype=torch.float32)
    tr = CFG["train"]
    depth = tr["subsample_candidates"]
    d = _draws(points, nv, b, depth, True)
    model = _port_model(weights)
    step = TrainStep(model, tuple(CFG["outputs"]), lr=tr["lr"],
                     momentum=tr["momentum"], patch_cfg=_patch_cfg(depth))
    losses, _ = step.train_step_fused(
        points, q, nv, gt, TrainDraws(d["offset"], d["logu"], d["rot"],
                                      ids=d["ids"]))
    grad = {k: float(torch.linalg.vector_norm(p.grad.double()))
            for k, p in model.named_parameters()}
    run = {"points": points, "n_valid": nv, "queries": q, "gt": gt,
           "draws": d, "rows": torch.arange(b)}
    ref_losses, ref_grad, _ = ref_train.run_steps(CFG, weights, [[run]])
    ref_grad = {k: float(torch.linalg.vector_norm(v.double()))
                for k, v in ref_grad.items()}
    assert abs(float(losses.sum()) - ref_losses[0]) <= 5e-6 * abs(
        ref_losses[0])
    assert leaf_gap(grad, ref_grad, ref_grad) <= 1.5e-3


@pytest.mark.parametrize("path", ["tiles", "fallback", "dense", "train"])
def test_slot_counters(cloud, path):
    """``extract.slots`` adds B·k once per call; ``extract.dense_slots``
    adds B·k whenever the dense selection runs (the fallback, an incoherent
    batch, a training batch)."""
    points, nv, q = cloud
    train = path == "train"
    tiles, coherent = PATHS["dense" if train else path]
    depth = CFG["train" if train else "eval"]["subsample_candidates"]
    d = _draws(points, nv, B, depth, train)
    draws = (TrainDraws(d["offset"], d["logu"], d["rot"], ids=d["ids"])
             if train else _eval_draws(d))
    with trace.recording() as got:
        extract_patches(points, q, nv, draws, cfg=_patch_cfg(depth, **tiles),
                        train=train, coherent=coherent)
    c = got["counters"]
    assert c["extract.slots"] == B * K
    assert c.get("extract.dense_slots", 0) == (0 if path == "tiles"
                                               else B * K)


def test_recorder_leaves_outputs_unchanged(cloud, weights):
    points, nv, q = cloud
    depth = CFG["eval"]["subsample_candidates"]
    d = _draws(points, nv, B, depth, False)
    fn = make_sdf_query_fn(_port_model(weights), tuple(CFG["outputs"]),
                           _patch_cfg(depth, **FALLBACK), fixed_radius=False)
    off = (_extract(points, nv, q, d, FALLBACK),
           fn(points, q, nv, _eval_draws(d)))
    with trace.recording() as got:
        on = (_extract(points, nv, q, d, FALLBACK),
              fn(points, q, nv, _eval_draws(d)))
    assert got["counters"]["extract.dense_slots"] == 2 * B * K
    for key, value in off[0].items():
        assert torch.equal(on[0][key], value), key
    assert torch.equal(on[1], off[1])
