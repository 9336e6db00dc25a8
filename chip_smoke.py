"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's SDF query path (``points2surf_tpu_torch``) at the full
width of ``bench.py``'s model (shared QSTN, net 1024, 300 patch points,
1000 sub-sample points, candidate decimation 4) with seeded random weights:

1. device: card name and power limit, torch/CUDA versions, kernel build;
2. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes of its call sites on the main path;
3. the whole slice on the GPU against the same slice on the CPU, on the
   bundled cloud, with the same weights and injected random draws;
4. throughput of the main path at batch 4096 on the grid-256 near-surface
   queries, with its stage split and the kernels' launch counts.

Any failed phase exits non-zero. The line before the last is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
SEED = 0
BATCH = 4096
WARMUP_BATCHES = 3
TIMED_BATCHES = 10
SPLIT_BATCHES = 5
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
# chain call sites of the bench model's forward: (Cin, n points, count)
CHAIN_SITES = ((3, 1300, 1), (64, 1000, 2), (64, 300, 2))
NET = 1024


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _events_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"capability {torch.cuda.get_device_capability(0)}")
    from points2surf_tpu_torch.ops.kernels import chain_pool as cp

    t0 = time.perf_counter()
    path, log = cp.build_library()
    cp._library()
    print(f"[device] chain_pool build+load {time.perf_counter() - t0:.3f} s "
          f"-> {os.path.relpath(path, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[device] ptxas: {line.strip()}")
    return card


def _random_chain(torch, gen, cin: int, device):
    """Three (W, a, c) layers with widths 64/128/1024, some negative a."""
    layers, ci = [], cin
    for co in (64, 128, NET):
        w = torch.randn((ci, co), generator=gen) / ci ** 0.5
        a = torch.rand((co,), generator=gen) * 2.0 - 0.5
        c = torch.randn((co,), generator=gen) * 0.1
        layers.append(tuple(t.to(device).contiguous() for t in (w, a, c)))
        ci = co
    return tuple(layers)


def phase_kernels(torch, device):
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_pool, chain_pool_reference)

    gen = torch.Generator().manual_seed(SEED)
    cases = [(64, n, cin) for cin, n, _ in CHAIN_SITES] + [(37, 129, 64),
                                                           (37, 129, 3)]
    max_err = 0.0
    times = {}
    for b, n, cin in cases:
        x = torch.randn((b, n, cin), generator=gen).to(device)
        layers = _random_chain(torch, gen, cin, device)
        for sym in ("max", "sum"):
            got = chain_pool(x, layers, sym_op=sym)
            want = chain_pool_reference(x, layers, sym_op=sym)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"chain_pool {b}x{n}x{cin} {sym}: bad output")
            err = (got - want).abs()
            atol = 1e-4 * float(want.abs().max())
            bad = int((err > atol + 1e-4 * want.abs()).sum())
            max_err = max(max_err, float(err.max()))
            msg = (f"[kernel] chain_pool B={b} n={n} cin={cin} {sym}: "
                   f"max_abs_err {float(err.max()):.3e} "
                   f"(atol {atol:.3e}, rtol 1e-4), {bad} outside")
            if b == 64:
                t_k = _events_ms(torch, lambda: chain_pool(
                    x, layers, sym_op=sym), 20)
                t_p = _events_ms(torch, lambda: chain_pool_reference(
                    x, layers, sym_op=sym), 20)
                times[(cin, n, sym)] = (t_k, t_p)
                flop = 2.0 * b * n * (cin * 64 + 64 * 128 + 128 * NET)
                msg += (f"; kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} "
                        f"TFLOP/s), plain {t_p:.4f} ms")
            print(msg)
            check(bad == 0, f"chain_pool disagrees with its plain version: "
                            f"B={b} n={n} cin={cin} {sym}")
    # one bench forward's five chains (max pool) at B=64
    ms = sum(cnt * times[(cin, n, "max")][0] for cin, n, cnt in CHAIN_SITES)
    plain_ms = sum(cnt * times[(cin, n, "max")][1]
                   for cin, n, cnt in CHAIN_SITES)
    print(f"[kernel] five chains of one B=64 forward: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _bench_model(torch, device):
    """bench.py's model with seeded default init and randomized BN stats."""
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.models.pointnet import BN

    torch.manual_seed(SEED)
    model = PointsToSurfModel(net_size_max=NET, output_dim=2,
                              use_point_stn=True, use_feat_stn=True,
                              shared_transformation=True)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BN):
                c = mod.num_features
                mod.weight.copy_(torch.rand((c,), generator=gen) + 0.5)
                mod.bias.copy_(torch.randn((c,), generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn((c,), generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand((c,), generator=gen) + 0.5)
    return model.eval().to(device)


def _sorted_points(torch, t):
    """Patch point sets in a canonical order (coordinates sorted per axis),
    so that order swaps of near-equal distances do not count."""
    return torch.sort(t, dim=1).values


def phase_slice(torch, np, device, cfg, model, pts_pad, n, queries):
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.ops.patches import (
        SubsampleDraws, extract_patches, subsample_candidates)

    q = queries[:256]
    rs = np.random.RandomState(SEED)
    stride, n_cand = subsample_candidates(pts_pad.shape[0], cfg, False)
    offset = rs.randint(max(stride, 1))
    tiny = np.finfo(np.float32).tiny
    logu = np.log(rs.uniform(tiny, 1.0, (len(q), n_cand))).astype(np.float32)
    cpu = torch.device("cpu")
    model_cpu = copy.deepcopy(model).to(cpu)
    res = []
    for dev, m in ((device, model), (cpu, model_cpu)):
        draws = SubsampleDraws(torch.tensor(offset, device=dev),
                               torch.from_numpy(logu).to(dev))
        pts_t = torch.from_numpy(pts_pad).to(dev)
        q_t = torch.from_numpy(q).to(dev)
        with torch.inference_mode():
            batch = extract_patches(pts_t, q_t, n, draws, cfg=cfg)
            pred = m(batch)
        sdf = make_sdf_query_fn(m, OUTPUTS, cfg, fixed_radius=False)(
            pts_t, q_t, n, draws)
        res.append({k: v.cpu() for k, v in batch.items()})
        res[-1]["pred"] = pred.cpu()
        res[-1]["sdf"] = sdf.cpu()
    g, c = res
    for key in ("patch_pts_ps", "pts_sub_sample_ms"):
        err = float((_sorted_points(torch, g[key])
                     - _sorted_points(torch, c[key])).abs().max())
        print(f"[slice] {key} {tuple(g[key].shape)} GPU vs CPU max_abs_err "
              f"{err:.3e} (atol 1e-5)")
        check(err <= 1e-5, f"{key} differs between GPU and CPU")
    err = float((g["patch_radius_ms"] - c["patch_radius_ms"]).abs().max())
    print(f"[slice] patch_radius_ms GPU vs CPU max_abs_err {err:.3e}")
    check(err <= 1e-5, "patch radii differ between GPU and CPU")
    pg, pc = g["pred"], c["pred"]
    check(bool(torch.isfinite(pg).all()) and pg.shape == (len(q), 2),
          "model output not finite or of the wrong shape")
    err = (pg - pc).abs()
    bad = int((err > 1e-4 + 1e-3 * pc.abs()).sum())
    print(f"[slice] raw model output {tuple(pg.shape)} GPU vs CPU max_abs_err "
          f"{float(err.max()):.3e} (rtol 1e-3, atol 1e-4), {bad} outside; "
          f"logit range [{float(pc[:, 1].min()):.4f}, "
          f"{float(pc[:, 1].max()):.4f}]")
    check(bad == 0, "raw model output differs between GPU and CPU")
    confident = pc[:, 1].abs() > 1e-3
    flips = int(((torch.sign(pg[:, 1]) != torch.sign(pc[:, 1]))
                 & confident).sum())
    print(f"[slice] sign disagreements where |logit| > 1e-3: {flips} of "
          f"{int(confident.sum())}")
    check(flips == 0, "signs differ between GPU and CPU")
    err = float((g["sdf"] - c["sdf"]).abs().max())
    print(f"[slice] signed distance GPU vs CPU max_abs_err {err:.3e}")
    check(bool(torch.isfinite(g["sdf"]).all()), "non-finite signed distance")


def phase_throughput(torch, device, cfg, model, pts_pad, n, queries):
    from points2surf_tpu_torch.infer.query import (
        make_sdf_query_fn, postprocess_sdf)
    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool
    from points2surf_tpu_torch.ops.patches import extract_patches

    pts_t = torch.from_numpy(pts_pad).to(device)
    q_all = torch.from_numpy(queries).to(device)
    check(len(queries) > BATCH, "too few grid queries for one batch")
    gen = torch.Generator(device=device).manual_seed(SEED)
    fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=False)

    def batch_queries(i):
        s = (i * BATCH) % (len(queries) - BATCH)
        return q_all[s:s + BATCH]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chain_pool.launches = 0
    for i in range(WARMUP_BATCHES):
        out = fn(pts_t, batch_queries(i), n, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_BATCHES, WARMUP_BATCHES + TIMED_BATCHES):
        out = fn(pts_t, batch_queries(i), n, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(out.shape == (BATCH,) and bool(torch.isfinite(out).all()),
          "query output not finite or of the wrong shape")
    # stage split, with CUDA events between the stages of the same path
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(SPLIT_BATCHES)]
    with torch.inference_mode():
        for j in range(SPLIT_BATCHES):
            q = batch_queries(WARMUP_BATCHES + TIMED_BATCHES + j)
            ev[j][0].record()
            batch = extract_patches(pts_t, q, n, gen, cfg=cfg)
            ev[j][1].record()
            pred = model(batch)
            ev[j][2].record()
            postprocess_sdf(pred, batch["patch_radius_ms"], OUTPUTS, False)
            ev[j][3].record()
    torch.cuda.synchronize()
    launches = chain_pool.launches
    n_batches = WARMUP_BATCHES + TIMED_BATCHES + SPLIT_BATCHES
    split = [sum(e[s].elapsed_time(e[s + 1]) for e in ev) / SPLIT_BATCHES
             for s in range(3)]
    qps = BATCH * TIMED_BATCHES / dt
    print(f"[main] {qps:.1f} queries/s at batch {BATCH} "
          f"({TIMED_BATCHES} timed batches, {dt / TIMED_BATCHES * 1e3:.2f} "
          f"ms/batch host clock)")
    print(f"[main] stage split per batch (CUDA events, mean of "
          f"{SPLIT_BATCHES}): extraction {split[0]:.2f} ms, forward "
          f"{split[1]:.2f} ms, post-processing {split[2]:.3f} ms")
    print(f"[main] chain_pool launches {launches} over {n_batches} batches "
          f"(expected {5 * n_batches})")
    print(f"[main] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(launches == 5 * n_batches,
          "chain_pool was not launched five times per forward")
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "points2surf_tpu_torch")):
        print("chip_smoke: points2surf_tpu_torch not found beside this file",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = phase_device(torch)
    kern = phase_kernels(torch, device)

    from points2surf_tpu_torch.ops.patches import PatchConfig
    from points2surf_tpu_torch.ops.voxel import grid_query_points

    pts = np.load(CLOUD)[:, :3].astype(np.float32)
    n = pts.shape[0]
    pts_pad = np.zeros((-(-n // 16384) * 16384, 3), np.float32)
    pts_pad[:n] = pts
    t0 = time.perf_counter()
    queries = grid_query_points(pts, 256, 3, device=device)
    print(f"[slice] grid-256 near-surface queries: {len(queries)} "
          f"({time.perf_counter() - t0:.2f} s), cloud {n} points padded to "
          f"{len(pts_pad)}")
    cfg = PatchConfig(points_per_patch=300, patch_radius=0.0,
                      sub_sample_size=1000, subsample_candidates=4)
    model = _bench_model(torch, device)
    print(f"[slice] model parameters "
          f"{sum(p.numel() for p in model.parameters())}")
    phase_slice(torch, np, device, cfg, model, pts_pad, n, queries)
    launches = phase_throughput(torch, device, cfg, model, pts_pad, n,
                                queries)
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [{
        "name": "chain_pool",
        "route": "cuda",
        "source": "points2surf_tpu_torch/csrc/chain_pool.cu",
        "replaces": "points2surf_tpu/ops/pallas/chain_kernel.py:187",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
