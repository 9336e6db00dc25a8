"""p2s_small_radius's ball patches in the port against the benchmark's plain
reference (``p2s_bench/reference/ball.py``) on the CPU, at a small size that
keeps the variant's shape: fixed-radius balls whose rows both pad (fewer
in-ball points than the patch) and subsample (more), a point STN inside the
global encoder whose rotation is applied to the patch too (net 64, k 40, S
32, r 0.07 on a 6,000-point cloud, batch 256).

Held: the keyed priorities bit for bit against the reference's own
implementation of their written definition; the tile path and the dense path
selecting the same sets from the same key; the extraction's patches against
the reference outside the rows whose result rounding decides (``TIE``), on
the tile, fallback and dense paths; the eval query's fixed-radius
distances; ``draw_batch``'s keyed eval draws (no host sync on the card);
the ``extract.priorities`` span and counter.
"""

import dataclasses
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "p2s_bench") not in sys.path:
    sys.path.append(str(ROOT / "p2s_bench"))

from reference import ball as ref_ball  # noqa: E402
from reference import data as ref_data  # noqa: E402
from reference import model as ref_model  # noqa: E402

from points2surf_tpu_torch.infer.query import make_sdf_query_fn  # noqa: E402
from points2surf_tpu_torch.models.p2s import PointsToSurfModel  # noqa: E402
from points2surf_tpu_torch.ops import patches as tp  # noqa: E402
from points2surf_tpu_torch.utils import trace  # noqa: E402

K, SUB, NET, R = 40, 32, 64, 0.07
N_CLOUD, N_PAD, B = 6000, 8192, 256
SHAPE = "00994122_57d9d4755722f9d2d7436f0a_trimesh_000"
# as the recon cell leaves out rows whose sign logit is this near 0
SIGN_TIE = 1e-4
# tile sizes at which the 8,192-row cloud has tiles at all (n > 2 M); the
# coherent batch certifies every tile
TILES = dict(tile_queries=32, tile_candidates=2048)


def _cfg() -> dict:
    cfg = json.loads((ROOT / "p2s_bench/configs/p2s_small_radius.json")
                     .read_text())
    cfg["model"]["net_size"] = NET
    cfg["patch"].update(points_per_patch=K, sub_sample_size=SUB,
                        patch_radius=R)
    return cfg


CFG = _cfg()
DEPTH = CFG["eval"]["subsample_candidates"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """(N_PAD, 3) cloud, its valid count, B queries near a patch of its
    surface (spatially coherent, as a grid's near-surface batch is) and B
    queries spread over the whole surface (whose tiles fail)."""
    pts = np.load(ROOT / "datasets/abc_minimal/04_pts" / f"{SHAPE}.xyz.npy")
    rng = np.random.RandomState(0)
    pts = pts[rng.choice(len(pts), N_CLOUD, replace=False), :3]
    points = torch.zeros((N_PAD, 3), dtype=torch.float32)
    points[:N_CLOUD] = torch.as_tensor(pts, dtype=torch.float32)
    near = np.argsort(np.linalg.norm(pts - pts[0], axis=1))[:B]
    q = pts[near] + rng.normal(0.0, 0.01, (B, 3))
    spread = pts[rng.choice(N_CLOUD, B, replace=False)] + rng.normal(
        0.0, 0.01, (B, 3))
    return (points, N_CLOUD, torch.as_tensor(q, dtype=torch.float32),
            torch.as_tensor(spread, dtype=torch.float32))


@pytest.fixture(scope="module")
def turning():
    """Seeded weights with the global encoder's point STN at full scale
    (its near-identity start turns the patch too little to tell)."""
    gen = torch.Generator().manual_seed(20240)
    w = ref_model.seeded_weights(ref_model.P2S(CFG["model"]), gen)
    return {k: v * 100.0 if k.startswith("feat_global.stn1.fc3") else v
            for k, v in w.items()}


def _port_model(weights):
    m = CFG["model"]
    model = PointsToSurfModel(
        net_size_max=m["net_size"], output_dim=m["output_dim"],
        use_point_stn=m["use_point_stn"], use_feat_stn=m["use_feat_stn"],
        sym_op=m["sym_op"], single_transformer=m["single_transformer"],
        shared_transformation=m["shared_transformation"])
    model.load_state_dict(weights, strict=True)
    return model


def _patch_cfg(**kw) -> tp.PatchConfig:
    return tp.PatchConfig(points_per_patch=K, patch_radius=R,
                          sub_sample_size=SUB, subsample_candidates=DEPTH,
                          **dict(TILES, **kw))


def _draws(points, nv, seed=5):
    """The benchmark's eval draws of a batch and its key, as
    ``traffic/recon_ball.py`` makes them."""
    gen = torch.Generator().manual_seed(seed)
    d = ref_data.make_draws(gen, B, points.shape[0], nv, CFG["patch"], DEPTH,
                            train=False)
    key = torch.randint(0, 2 ** 32, (), generator=gen)
    return d, key


def _program_draws(d, key) -> tp.SubsampleDraws:
    return tp.SubsampleDraws(d["offset"], d["logu"], ids=d["ids"],
                             ball=tp.BallDraws.keyed(key))


def _reference(points, nv, q, d, key):
    return ref_ball.patches(points, nv, q, torch.arange(len(q)), key, d,
                            CFG["patch"], DEPTH)


def _slots(batch, i):
    """Row ``i``'s selected point ids (its pad slots left out), sorted."""
    real = torch.linalg.vector_norm(batch["patch_pts_ps"][i], dim=-1) > 0
    return torch.sort(batch["patch_pts_ids"][i][real])[0]


def test_keyed_hash_matches_reference_bit_for_bit():
    """The port's priorities and the reference's, written from the same
    text, over keys that use all 32 bits (and one past them), rows and ids;
    and a few against plain Python integers."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) % 2 ** 32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) % 2 ** 32
        return h ^ (h >> 16)

    rows = torch.arange(0, 4100, 13)[:, None]
    ids = torch.arange(0, 100_000, 7)[None, :]
    for key in (0, 1, 2 ** 31 + 5, 2 ** 32 - 1, 2 ** 32 + 77):
        k = torch.tensor(key)
        got = tp.ball_priorities(k, rows, ids)
        assert got.dtype == torch.float32
        assert torch.equal(got, ref_ball.priorities(k, rows, ids))
        assert 0.0 <= float(got.min()) and float(got.max()) < 1.0
        for j, i in ((0, 0), (13, 7), (4095, 99_995)):
            want = fmix(fmix((key % 2 ** 32) ^ j) ^ i) >> 8
            assert float(got[j // 13, i // 7]) == want / 2 ** 24
    u = tp.ball_priorities(torch.tensor(9), rows, ids)
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_tile_and_dense_paths_select_alike(cloud):
    """The same keyed draws on the tile path and on the forced dense path
    (``exact``) give each row the same set, left out only the rows with a
    point whose squared distance lies within the rounding band of r^2 (the
    two paths form it through different products)."""
    points, nv, q, _ = cloud
    d, key = _draws(points, nv)
    with trace.recording() as got:
        tiled = tp.extract_patches(points, q, nv, _program_draws(d, key),
                                   cfg=_patch_cfg())
    assert got["counters"].get("extract.fallback", 0) == 0
    exact_cfg = _patch_cfg(exact=True)
    gen = torch.Generator().manual_seed(6)
    exact_draws = dataclasses.replace(
        tp.draw_batch(gen, B, N_PAD, exact_cfg, n_valid=nv),
        ball=tp.BallDraws.keyed(key))
    dense = tp.extract_patches(points, q, nv, exact_draws, cfg=exact_cfg)
    d2 = ref_data.sqdist(q, points, False)
    band = ref_ball.BAND * (torch.sum(q * q, 1)[:, None]
                            + torch.sum(points * points, 1)[None, :])
    edge = ((d2 - R * R).abs() <= band)[:, :nv].any(1)
    assert int(edge.sum()) < B // 8
    pads = 0
    for i in range(B):
        a, b = _slots(tiled, i), _slots(dense, i)
        pads += K - len(a)
        if not edge[i]:
            assert torch.equal(a, b), i
    # both kinds of row are here: balls with fewer points than the patch,
    # and balls with more
    assert 0 < pads < B * K // 2


@pytest.mark.parametrize("path", ["tiles", "fallback", "dense"])
def test_extraction_matches_reference(cloud, path):
    points, nv, q, spread = cloud
    if path == "fallback":
        q = spread
    d, key = _draws(points, nv)
    with trace.recording() as got:
        batch = tp.extract_patches(points, q, nv, _program_draws(d, key),
                                   cfg=_patch_cfg(),
                                   coherent=path != "dense")
    c = got["counters"]
    assert c.get("extract.tiled", 0) == int(path != "dense")
    assert c.get("extract.fallback", 0) == int(path == "fallback")
    pts_ps, radius, sub, _, tie, pad = _reference(points, nv, q, d, key)
    assert int(torch.count_nonzero(tie)) < B // 4
    assert 0 < int(pad.sum()) and int(torch.count_nonzero(pad == 0)) > 0
    assert torch.equal(batch["patch_radius_ms"], torch.full((B,), R))
    torch.testing.assert_close(batch["pts_sub_sample_ms"][~tie], sub[~tie],
                               rtol=0, atol=0)
    sel = torch.linalg.vector_norm(pts_ps, dim=-1) > 0
    for i in torch.nonzero(~tie)[:, 0].tolist():
        ids = _slots(batch, i)
        assert len(ids) == K - int(pad[i])
        # the reference's points of the row, as sets of coordinates
        want = torch.sort(pts_ps[i][sel[i]], dim=0)[0]
        got_ps = torch.linalg.vector_norm(batch["patch_pts_ps"][i], dim=-1)
        have = torch.sort(batch["patch_pts_ps"][i][got_ps > 0], dim=0)[0]
        torch.testing.assert_close(have, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", ["tiles", "dense"])
def test_eval_query_matches_reference(cloud, turning, path):
    """The eval query's fixed-radius distances (tanh^2 magnitude and sign,
    not scaled by r) against the reference's within 1e-5 of r outside
    ``TIE`` rows and near-zero sign logits: float32 rounding of the same
    products reads ~1e-7, a patch or a rotation missed ~1e-3."""
    points, nv, q, _ = cloud
    d, key = _draws(points, nv)
    fn = make_sdf_query_fn(_port_model(turning), tuple(CFG["outputs"]),
                           _patch_cfg(), fixed_radius=True,
                           coherent=path == "tiles")
    got = fn(points, q, nv, _program_draws(d, key))
    ref = ref_model.P2S(CFG["model"]).eval()
    ref.load_state_dict(turning)
    with torch.no_grad():
        pts_ps, radius, sub, qm, tie, _ = _reference(points, nv, q, d, key)
        pred = ref(pts_ps, sub, qm)
    want = ref_ball.fixed_radius_distance(pred)
    sure = ~tie & (pred[:, 1].abs()
                   >= SIGN_TIE * torch.median(pred[:, 1].abs()))
    assert int(torch.count_nonzero(sure)) > 3 * B // 4
    err = torch.abs(got[sure] - want[sure]) / radius[sure]
    assert float(err.max()) <= 1e-5


def test_draw_batch_keys_eval_draws():
    """In ball mode ``draw_batch`` makes eval draws keyed by one key drawn
    on the generator after the sub-sample's numbers (nothing from the
    host: no ``host_syncs``), and training draws from the generator."""
    cfg = _patch_cfg()
    with trace.recording() as got:
        d = tp.draw_batch(torch.Generator().manual_seed(3), B, N_PAD, cfg,
                          n_valid=N_CLOUD)
    assert "host_syncs" not in got["counters"]
    assert d.ball.source is None
    assert d.ball.key.dtype == torch.int64 and d.ball.key.dim() == 0
    gen = torch.Generator().manual_seed(3)
    tp.draw_subsample(gen, B, N_PAD, cfg, n_valid=N_CLOUD)
    assert torch.equal(d.ball.key,
                       torch.randint(0, 2 ** 32, (), generator=gen))
    t = tp.draw_batch(torch.Generator().manual_seed(3), B, N_PAD, cfg,
                      train=True, n_valid=N_CLOUD)
    assert t.ball.key is None and t.ball.source is not None
    assert tp.draw_batch(torch.Generator(), B, N_PAD, tp.PatchConfig(),
                         n_valid=N_CLOUD).ball is None


@pytest.mark.parametrize("path", ["tiles", "dense"])
def test_priorities_counter(cloud, path):
    """``extract.priorities`` counts the priorities hashed: T·tile·M on
    the tile path, rows·N on the dense path; block draws hash none."""
    points, nv, q, _ = cloud
    d, key = _draws(points, nv)
    cfg = _patch_cfg()
    with trace.recording() as got:
        tp.extract_patches(points, q, nv, _program_draws(d, key), cfg=cfg,
                           coherent=path == "tiles")
    m = tp._ball_tile_candidates(cfg, N_PAD)
    want = B * m if path == "tiles" else B * N_PAD
    assert got["counters"]["extract.priorities"] == want
    by_id = {s["id"]: s for s in got["spans"]}
    hashed = [s for s in got["spans"] if s["name"] == "extract.priorities"]
    assert [by_id[s["parent"]]["name"] for s in hashed] == [
        "extract.tiles" if path == "tiles" else "extract.dense"]
    block = dataclasses.replace(_program_draws(d, key),
                                ball=tp.BallDraws.from_generator(
                                    torch.Generator().manual_seed(1)))
    with trace.recording() as got:
        tp.extract_patches(points, q, nv, block, cfg=cfg,
                           coherent=path == "tiles")
    assert "extract.priorities" not in got["counters"]


@pytest.mark.cuda
def test_keyed_ball_batch_syncs_only_where_counted_on_the_card(cloud):
    """On the card, ``draw_batch``'s keyed eval draws sync nothing, and a
    ball-mode query's ``host_syncs`` equal torch's count of synchronizing
    calls (the radius copy and the certificate)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    points, nv, q, _ = cloud
    points, q = points.to(dev), q.to(dev)
    cfg = _patch_cfg()
    gen = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        draws = tp.draw_batch(gen, B, N_PAD, cfg, n_valid=nv)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert draws.ball.key.device.type == "cuda"
    fn = make_sdf_query_fn(_port_model(ref_model.seeded_weights(
        ref_model.P2S(CFG["model"]), torch.Generator().manual_seed(1)))
        .to(dev), tuple(CFG["outputs"]), cfg, fixed_radius=True)
    fn(points, q, nv, draws)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording() as got:
                fn(points, q, nv, draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum(str(w.message).startswith(
        "called a synchronizing CUDA operation") for w in caught)
    assert syncs >= 2
    assert got["counters"].get("host_syncs", 0) == syncs
