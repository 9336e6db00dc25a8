"""The port's recorder (``utils/trace.py``): off by default, spans nested per
thread, and the spans and counters the port records in a reconstruction
batch, a train step, the writes and the volume, with results bit-identical
whether it records or not. On the card, ``host_syncs`` against torch's own
count of synchronizing calls."""

import os
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.data.shapes import bucket_size
from points2surf_tpu_torch.infer import evaluator, meshing
from points2surf_tpu_torch.infer.query import make_sdf_query_fn
from points2surf_tpu_torch.models.p2s import PointsToSurfModel
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.ops import voxel
from points2surf_tpu_torch.train.trainer import make_train_step
from points2surf_tpu_torch.utils import trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
KW = dict(points_per_patch=32, sub_sample_size=64, tile_candidates=1024,
          tile_queries=32, subsample_candidates=4)


def recorded(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the spans and counters the port recorded while
    it ran)."""
    with trace.recording() as got:
        out = fn(*args, **kwargs)
    return out, got


def _cloud(device="cpu"):
    pts = np.load(CLOUD).astype(np.float32)
    padded = np.zeros((bucket_size(len(pts)), 3), np.float32)
    padded[:len(pts)] = pts
    return torch.from_numpy(padded).to(device), len(pts)


def _model(net=32, device="cpu", **kw):
    torch.manual_seed(0)
    return PointsToSurfModel(net_size_max=net, output_dim=2, **kw).to(device)


def _recon_batch(b=128, device="cpu", cfg=None):
    """A coherent batch of grid queries of the cloud and its draws."""
    pts, n = _cloud(device)
    cfg = cfg or tp.PatchConfig(**dict(KW, tile_candidates=2048))
    q = voxel.grid_query_points(np.load(CLOUD), 128, 3, device="cpu")[:b]
    gen = torch.Generator(device=device).manual_seed(3)
    draws = tp.draw_batch(gen, b, pts.shape[0], cfg, n_valid=n)
    return pts, n, torch.from_numpy(q).to(device), draws, cfg


# -- the recorder ------------------------------------------------------------


def test_off_by_default_records_nothing():
    code = ("from points2surf_tpu_torch.utils import trace\n"
            "assert not trace.enabled()\n"
            "s = trace.span('query.extract', batch=1)\n"
            "assert s is trace.NULL and trace.span('x') is s\n"
            "assert trace.blocking('cuda', 2) is s\n"
            "with s:\n"
            "    trace.count('host_syncs')\n"
            "    trace.count_sizes('write.bytes', '/nonexistent/file')\n"
            "out = trace.take()\n"
            "assert out == {'spans': [], 'counters': {}}, out\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_spans_nest_per_thread_and_take_clears():
    trace.take()
    trace.enable()
    seen = {}

    def writer():
        with trace.span("write.off"):
            with trace.span("write.inner"):
                seen["tid"] = threading.get_native_id()
        trace.count("write.bytes", 7)

    try:
        with trace.span("query.extract", batch=3):
            with trace.span("extract.tiles"):
                t = threading.Thread(target=writer)
                t.start()
                t.join()
            trace.count("host_syncs", 2)
            trace.count("host_syncs")
    finally:
        trace.disable()
    got = trace.take()
    by = {s["name"]: s for s in got["spans"]}
    assert set(by) == {"query.extract", "extract.tiles", "write.off",
                       "write.inner"}
    assert by["query.extract"]["parent"] == 0
    assert by["query.extract"]["attrs"] == {"batch": 3}
    assert by["extract.tiles"]["parent"] == by["query.extract"]["id"]
    # the writer thread's spans have a stack of their own
    assert by["write.off"]["parent"] == 0
    assert by["write.inner"]["parent"] == by["write.off"]["id"]
    assert by["write.off"]["tid"] == seen["tid"] != by["query.extract"]["tid"]
    assert by["query.extract"]["tid"] == threading.get_native_id()
    for s in got["spans"]:
        assert s["t0_ns"] <= s["t1_ns"]
    assert (by["query.extract"]["t0_ns"] <= by["extract.tiles"]["t0_ns"]
            <= by["extract.tiles"]["t1_ns"] <= by["query.extract"]["t1_ns"])
    assert got["counters"] == {"host_syncs": 3, "write.bytes": 7}
    assert trace.take() == {"spans": [], "counters": {}}


def test_blocking_records_a_wait_on_the_card_only():
    """A wait on a CUDA device is a ``sync.wait`` span and its count in
    ``host_syncs``; on the CPU nothing waits, and nothing is recorded."""
    with trace.recording() as got:
        with trace.span("train.forward"):
            with trace.blocking(torch.device("cuda", 0), 2):
                pass
            with trace.blocking("cuda"):
                pass
            with trace.blocking(torch.device("cpu")):
                pass
    assert not trace.enabled()
    by = {}
    for s in got["spans"]:
        by.setdefault(s["name"], []).append(s)
    assert sorted(by) == ["sync.wait", "train.forward"]
    assert len(by["sync.wait"]) == 2
    assert all(s["parent"] == by["train.forward"][0]["id"]
               for s in by["sync.wait"])
    assert got["counters"] == {"host_syncs": 3}


# -- the port's spans and counters -------------------------------------------


def test_recon_batch_records_extraction_inside_the_query():
    pts, n, q, draws, cfg = _recon_batch()
    fn = make_sdf_query_fn(_model(), OUTPUTS, cfg, fixed_radius=False)
    _, got = recorded(fn, pts, q, n, draws)
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    for name in ("query.extract", "query.forward", "query.post",
                 "extract.tiles", "extract.certify", "extract.subsample"):
        assert names.count(name) == 1, name
    assert "extract.dense" not in names
    for s in spans:
        if s["name"].startswith("extract."):
            assert by_id[s["parent"]]["name"] == "query.extract"
    assert got["counters"]["extract.tiled"] == 1
    assert "extract.fallback" not in got["counters"]
    # the certificate and the QSTN's constant block on a card, not here
    assert "host_syncs" not in got["counters"]
    assert "sync.wait" not in names


def test_failed_certificate_counts_a_fallback(monkeypatch):
    real = tp._tile_select

    def planted(*args, **kwargs):
        ids, pad, cert = real(*args, **kwargs)
        return ids, pad, torch.zeros_like(cert)

    monkeypatch.setattr(tp, "_tile_select", planted)
    pts, n, q, draws, cfg = _recon_batch()
    fn = make_sdf_query_fn(_model(), OUTPUTS, cfg, fixed_radius=False)
    _, got = recorded(fn, pts, q, n, draws)
    names = [s["name"] for s in got["spans"]]
    assert got["counters"]["extract.tiled"] == 1
    assert got["counters"]["extract.fallback"] == 1
    assert names.count("extract.dense") == 1


def _train_step(model, cfg):
    return make_train_step(model, OUTPUTS, patch_cfg=cfg)


def _train_inputs(b=48):
    pts, n = _cloud()
    rng = np.random.RandomState(1)
    q = torch.from_numpy(
        (np.load(CLOUD)[rng.choice(n, b)] + 0.01 * rng.randn(b, 3))
        .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(-0.05, 0.05, b).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    cfg = tp.PatchConfig(**KW)
    draws = tp.draw_batch(gen, b, pts.shape[0], cfg, train=True, n_valid=n)
    return pts, n, q, gt, draws, cfg


def test_fused_train_step_records_each_part_once():
    pts, n, q, gt, draws, cfg = _train_inputs()
    step = _train_step(_model(), cfg)
    _, got = recorded(step.train_step_fused, pts, q, n, gt, draws)
    names = [s["name"] for s in got["spans"]]
    for name in ("train.extract", "train.forward", "train.backward",
                 "train.update", "train.metrics"):
        assert names.count(name) == 1, name
    assert all(s["parent"] == 0 for s in got["spans"]
               if s["name"].startswith("train."))


def test_write_bytes_are_the_files_sizes(tmp_path):
    q = voxel.grid_query_points(np.load(CLOUD), 32, 3, device="cpu")
    dist = (0.3 - np.linalg.norm(q, axis=1)).astype(np.float32)
    opt = type("EvalOpt", (), {"reconstruction": True})()

    def write_all():
        evaluator._save_shape("s", q, dist, opt, str(tmp_path / "rec"))
        meshing._write_debug_volume(q, dist, str(tmp_path / "vol" / "s.off"))
        vol = meshing._device_volume(q, dist, 32, 5, 13, 0, "cpu")
        assert meshing._extract_and_write(vol, str(tmp_path / "mesh" /
                                                   "s.ply"), 32, q)

    _, got = recorded(write_all)
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
             for f in fs]
    assert len(files) == 5  # 2 npy, the query PLY, the OFF, the mesh PLY
    assert got["counters"]["write.bytes"] == sum(map(os.path.getsize, files))
    names = {s["name"] for s in got["spans"]}
    assert {"write.npy", "write.query_ply", "write.off", "write.mesh_ply",
            "mesh.marching", "volume.upload", "volume.splat",
            "volume.propagate", "volume.fetch"} <= names


@pytest.mark.parametrize("res,sigma,certainty,rounds",
                         [(20, 5, 13, 6), (24, 3, 3, 5)])
def test_volume_rounds_as_the_stats_dict_gave(res, sigma, certainty, rounds):
    """The rounds that ``propagate_sign(..., stats)`` reported for these
    volumes before the counter replaced it."""
    rng = np.random.RandomState(0)
    centers = voxel.make_grid_points(res).reshape(res, res, res, 3)
    d = np.linalg.norm(centers, axis=-1)
    vol = np.zeros((res, res, res), np.float32)
    seeds = rng.rand(res, res, res) < 0.08
    vol[seeds] = np.where(d[seeds] < 0.5, 0.4, -0.4)
    vol[seeds & (rng.rand(res, res, res) < 0.02)] *= -1.0
    _, got = recorded(voxel.propagate_sign, torch.from_numpy(vol), sigma,
                      certainty)
    counters = got["counters"]
    assert counters["volume.rounds"] == rounds
    assert "host_syncs" not in counters  # a round's test waits on a card


def test_results_bit_identical_with_the_recorder_on():
    pts, n, q, draws, cfg = _recon_batch()
    fn = make_sdf_query_fn(_model(), OUTPUTS, cfg, fixed_radius=False)
    off = fn(pts, q, n, draws)
    on, _ = recorded(fn, pts, q, n, draws)
    assert torch.equal(off, on)

    qn = voxel.grid_query_points(np.load(CLOUD), 32, 3, device="cpu")
    dist = (0.3 - np.linalg.norm(qn, axis=1)).astype(np.float32)
    vol_off = meshing._device_volume(qn, dist, 32, 5, 13, 0, "cpu")
    vol_on, _ = recorded(meshing._device_volume, qn, dist, 32, 5, 13, 0,
                         "cpu")
    np.testing.assert_array_equal(vol_off, vol_on)

    pts, n, q, gt, draws, cfg = _train_inputs()
    params = []
    for record in (False, True):
        step = _train_step(_model(), cfg)
        run = step.train_step_fused
        losses = (recorded(run, pts, q, n, gt, draws)[0] if record
                  else run(pts, q, n, gt, draws))
        params.append([losses[0]] + [p.detach().clone()
                                     for p in step.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*params))


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("point_stn", [True, False])
@pytest.mark.parametrize("part", ["recon", "train"])
def test_host_syncs_equal_torchs_count_on_the_card(part, point_stn):
    """A reconstruction batch (2048 queries) and a fused train step (batch
    512) at net 1024, their inputs on the card: every call that torch's
    sync debug mode flags is counted in ``host_syncs``, and nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    pts, n = _cloud(dev)
    model = _model(1024, dev, use_point_stn=point_stn,
                   shared_transformation=point_stn)
    cfg = tp.PatchConfig()
    gen = torch.Generator(device=dev).manual_seed(11)
    if part == "recon":
        q = voxel.grid_query_points(np.load(CLOUD), 256, 3,
                                    device=dev)[:2048]
        q = torch.from_numpy(q).to(dev)
        draws = tp.draw_batch(gen, len(q), pts.shape[0], cfg, n_valid=n)
        fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=False)
        args = (pts, q, n, draws)
    else:
        rng = np.random.RandomState(2)
        q = torch.from_numpy((np.load(CLOUD)[rng.choice(n, 512)]
                              + 0.01 * rng.randn(512, 3)).astype(
                                  np.float32)).to(dev)
        gt = torch.from_numpy(rng.uniform(-0.05, 0.05, 512).astype(
            np.float32)).to(dev)
        draws = tp.draw_batch(gen, len(q), pts.shape[0], cfg, train=True,
                              n_valid=n)
        fn = _train_step(model, cfg).train_step_fused
        args = (pts, q, n, gt, draws)
    fn(*args)  # builds or loads the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, got = recorded(fn, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counters = got["counters"]
    syncs = sum(str(w.message).startswith(
        "called a synchronizing CUDA operation") for w in caught)
    assert syncs >= 1
    assert counters.get("host_syncs", 0) == syncs, [
        str(w.message) for w in caught]


@pytest.mark.cuda
def test_volume_host_syncs_equal_torchs_count_on_the_card():
    """The volume of a reconstruction on the card (upload, splat,
    propagation rounds, fetch): one ``host_syncs`` per call that torch's
    sync debug mode flags, one per round among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    qn = voxel.grid_query_points(np.load(CLOUD), 64, 3, device="cuda")
    dist = (0.3 - np.linalg.norm(qn, axis=1)).astype(np.float32)
    args = (qn, dist, 64, 5, 13, 0, "cuda")
    meshing._device_volume(*args)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, got = recorded(meshing._device_volume, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counters = got["counters"]
    syncs = sum(str(w.message).startswith(
        "called a synchronizing CUDA operation") for w in caught)
    assert counters["volume.rounds"] >= 2
    assert counters["host_syncs"] == syncs >= counters["volume.rounds"], [
        str(w.message) for w in caught]
