"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths (``points2surf_tpu_torch``) at the full width
of ``bench.py``'s model (shared QSTN, net 1024, 300 patch points, 1000
sub-sample points) with seeded random weights: the SDF query (candidate
decimation 4), the fused train step (decimation 8, SGD with momentum) and
the reconstruction of a 256^3 mesh:

1. device: card name and power limit, torch/CUDA versions, the kernels'
   build (one ``nvcc`` per source, in parallel);
2. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes of its call sites: the eval chain's two kernels
   (``chain_head``, layers 1-2, and ``chain_pool``, layer 3 and the pool)
   at batch 64 and at the query batch 4096 (plain versions in row chunks
   there), with their times and the five chains' share of their bound;
   ``pooled_tail`` at the train path's three tail shapes (each run twice,
   bit-identical), with the five tails' share of their bound;
   ``mlp_maxpool``, which no path calls, at four encoder-tail shapes
   (``MLP_SHAPES``);
3. the query slice on the GPU against the same slice on the CPU, on the
   bundled cloud, with the same weights and injected random draws;
4. query throughput at batch 4096 on the grid-256 near-surface queries,
   with its stage split, the chain kernels' launch counts and a
   ``torch.profiler`` summary (device time by kernel, idle share);
5. one fused train step on the GPU against the same step on the CPU in
   float64 at batch 64: same weights, momentum buffers, random draws and
   rotations;
6. train throughput at batch 1000, with its stage split,
   ``pooled_tail``'s launch count and a ``torch.profiler`` summary;
7. seconds per 256^3 mesh by ``bench.py``'s recipe, through the port:
   grid-256 queries, the query sweep at batch 4096, a proxy sign over the
   sweep's magnitudes, the volume (splat, sign propagation) on the card,
   an f32 fetch and the C++ marching tetrahedra, split by stage, with the
   propagation rounds, vertex and face counts, peak memory and the chain
   kernels' launch counts; then the GPU volume against the CPU volume bit
   for bit (seed filter 0 and 4), a watertight mesh, a byte-identical
   second marching, and the single-shape and directory entry points
   writing the same mesh from the card;
8. the driver path: the port's ``full_run`` (``cli/full_run.py``) on a
   copy of ``datasets/abc_minimal`` in a temporary directory, with its
   defaults (vanilla with non-shared transformers, net 1024, 300 / 1000
   points, batch 100, 1000 patches per shape, grid 128) but 2 epochs:
   training, the eval pass and its MSE CSV, the reconstruction, meshing
   and the Hausdorff/Chamfer CSV, each stage timed on the host clock and
   its kernel launches counted (``pooled_tail`` 5 per train step, both
   chain kernels 5 per eval and reconstruction batch); each kernel against
   its plain version at the call sites the run reached (batch 100); the
   checkpoint's keys against a CPU trainer's and the checkpoint loaded
   into a CPU model; the first two reconstruction batches on the card
   against the CPU with the same draws, and a ``torch.profiler`` summary
   of ten batch-100 reconstruction batches; a watertight mesh and a finite
   row in each CSV;
9. the bf16-operand modes (``P2S_EVAL_CHAIN_PREC=default``,
   ``P2S_PALLAS_TAIL_PREC=default``; phases 1-8 run in fp32 mode, the
   port's default): each bf16 kernel against its plain bf16 version at
   phase 4's five chain call sites (batch 4096) and phase 6's five tails
   (batch 1000), with times; the bf16 query at batch 4096 (queries/s, 5 + 5
   bf16 launches per forward) and, over every grid-256 query, its sign
   agreement and max |diff| against fp32 mode; the bf16 train step at
   batch 1000 (patches/s, 5 bf16 launches per step) and one step at batch
   64 on the card against the CPU, both in bf16 mode; phase 8's trained
   checkpoint reconstructed at grid 128 in both modes (sign agreement,
   faces, Chamfer and Hausdorff distance between the two meshes).

Any failed phase exits non-zero. The line before the last is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
SEED = 0
BATCH = 4096
WARMUP_BATCHES = 3
TIMED_BATCHES = 10
SPLIT_BATCHES = 5
PROFILE_BATCHES = 3
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
# chain call sites of the bench model's forward: (Cin, n points, count)
CHAIN_SITES = ((3, 1300, 1), (64, 1000, 2), (64, 300, 2))
NET = 1024
# conv3 tails of one train forward (Cin 128 -> NET): (n points, count)
TAIL_SITES = ((1300, 1), (1000, 2), (300, 2))
TRAIN_BATCH = 1000
TRAIN_WARMUP = 3
TRAIN_TIMED = 10
TRAIN_SPLIT = 3
TRAIN_PROFILE = 3
SLICE_TRAIN_BATCH = 64
# the mesh: bench.py's bench_mesh (grid 256, epsilon 3, sigma 5, certainty
# 13), one warm-up pass and MESH_PASSES timed passes
MESH_GRID = 256
MESH_SIGMA = 5
MESH_CERTAINTY = 13
MESH_PASSES = 2
KERNEL_SOURCES = ("chain_head", "chain_pool", "pooled_tail", "mlp_maxpool")
# least-time bounds: fp32-class work at 3xTF32 on the 495 TFLOP/s dense TF32
# peak, bf16-operand work at the 989 TFLOP/s dense bf16 peak, and HBM3 at
# 3.35 TB/s (H100 SXM data sheet)
PEAK_FLOPS = 495e12 / 3
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
# mlp_maxpool shapes (B, n, Cin, Cout): the JAX package's test, the local
# encoder tail at batch 64, the local and global encoder tails at the train
# batch; the JSON line reports the second
MLP_SHAPES = ((16, 256, 128, 512), (64, 300, 128, NET),
              (TRAIN_BATCH, 300, 128, NET), (TRAIN_BATCH, 1000, 128, NET))
# phase 8: the port's full_run with its defaults (vanilla, non-shared
# transformers, batch 100, grid 128) but DRIVER_NEPOCH epochs instead of 10
DRIVER_DATASET = "abc_minimal"
DRIVER_BATCH = 100
DRIVER_GRID = 128
DRIVER_NEPOCH = 2
DRIVER_PROFILE = 10  # reconstruction batches traced after the run
# phase 9: the bf16-operand modes, selected as in the JAX package
BF16_ENV = {"chain": "P2S_EVAL_CHAIN_PREC", "tail": "P2S_PALLAS_TAIL_PREC"}
BF16_WARMUP = 2
BF16_TIMED = 5
# the whole chain in bf16 against its plain version, rtol and atol x
# max|ref|: one bf16 ulp (2^-8) of the output, which is what an h1 or h2
# operand one ulp off (the two fp32 sums straddle a rounding boundary) can
# move it by at most
BF16_CHAIN_TOL = 2.0 ** -8


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


def _card_state(tag: str) -> None:
    """SM clock, power draw, temperature and the active clock-limit reasons
    (a bit mask; 0 means none), to tell a throttled run from a slow one."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"[{tag}] card state: {(out.stdout or out.stderr).strip()}")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"capability {torch.cuda.get_device_capability(0)}")
    from concurrent.futures import ThreadPoolExecutor

    from points2surf_tpu_torch.ops import marching_native
    from points2surf_tpu_torch.ops.kernels import build
    from points2surf_tpu_torch.ops.kernels import chain_pool as cp
    from points2surf_tpu_torch.ops.kernels import mlp_maxpool as mm
    from points2surf_tpu_torch.ops.kernels import pooled_tail as pt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as ex:
        marching = ex.submit(marching_native.build_library)
        built = list(ex.map(build.build_library, KERNEL_SOURCES))
        marching_path, _ = marching.result()
    cp._head_library()
    cp._tail_library()
    pt._library()
    mm._library()
    marching_native._library()
    print(f"[device] {len(built)} kernel sources built in parallel + loaded "
          f"in {time.perf_counter() - t0:.3f} s; the marching copy (g++ "
          f"-fopenmp) beside them -> {os.path.relpath(marching_path, ROOT)}")
    for name, (path, log) in zip(KERNEL_SOURCES, built):
        print(f"[device] {name} -> {os.path.relpath(path, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[device] ptxas {name}: {line.strip()}")
    return card


def _close(got, want, what: str):
    """(max abs err, elements outside rtol 1e-4 / atol 1e-4 * max|want|)."""
    err = (got.double() - want.double()).abs()
    atol = 1e-4 * float(want.abs().max())
    bad = int((err > atol + 1e-4 * want.double().abs()).sum())
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    return float(err.max()), bad


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


def _bound(flop: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least ms on the card, what bounds it): FLOP at ``peak`` (fp32-class
    work at PEAK_FLOPS, bf16 operands at PEAK_FLOPS_BF16), bytes (each input
    read once, each output written once) at PEAK_BYTES."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _head_cost(b, n, cin, h2_bytes=4):
    """(FLOP, bytes) of chain_head: layers 1-2 of b * n points (h2 of
    ``h2_bytes`` per element: 4 in fp32 mode, 2 in bf16)."""
    flop = 2.0 * b * n * (cin * 64 + 64 * 128)
    nbytes = (4.0 * (b * n * cin + cin * 64 + 64 * 128 + 2 * 192)
              + h2_bytes * b * n * 128)
    return flop, nbytes


def _tail_cost(b, n, cout=NET, h2_bytes=4):
    """(FLOP, bytes) of the layer-3 kernel: 128 -> cout and the pool."""
    flop = 2.0 * b * n * 128 * cout
    nbytes = (h2_bytes * b * n * 128
              + 4.0 * (128 * cout + 2 * cout + b * cout))
    return flop, nbytes


def _pooled_tail_cost(b, n, cout=NET):
    """(FLOP, bytes) of pooled_tail: 128 -> cout and six (b, cout) outputs."""
    flop = 2.0 * b * n * 128 * cout
    nbytes = 4.0 * (b * n * 128 + 128 * cout + cout + 6 * b * cout)
    return flop, nbytes


def _chunked(torch, fn, x, rows: int):
    """fn over row chunks of x, concatenated: the plain versions at the
    query batch would otherwise materialize (4096, n, 1024) activations."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def phase_kernels(torch, device):
    """chain_head and the layer-3 kernel (chain_pool) against their plain
    versions: the call sites at batch 64 and at the query batch, ragged n,
    B = 1; timings at both batches."""
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_head_reference, chain_pool, chain_pool_reference,
        chain_tail, chain_tail_reference)

    gen = torch.Generator().manual_seed(SEED)
    dgen = torch.Generator(device=device).manual_seed(SEED + 5)
    cases = [(64, n, cin) for cin, n, _ in CHAIN_SITES] + [
        (BATCH, n, cin) for cin, n, _ in CHAIN_SITES] + [
        (37, 129, 64), (37, 129, 3), (1, 77, 3)]
    err = {"chain_head": 0.0, "chain_pool": 0.0, "chain": 0.0}
    times = {}
    for b, n, cin in cases:
        x = torch.randn((b, n, cin), generator=dgen, device=device)
        layers = _random_chain(torch, gen, cin, device)
        h2 = chain_head(x, layers[:2])
        e, bad = _close(h2, chain_head_reference(x, layers[:2]),
                        "chain_head")
        err["chain_head"] = max(err["chain_head"], e)
        print(f"[kernel] chain_head B={b} n={n} cin={cin}: max_abs_err "
              f"{e:.3e} (rtol 1e-4, atol 1e-4*max|ref|), {bad} outside")
        check(bad == 0, f"chain_head disagrees with its plain version: "
                        f"B={b} n={n} cin={cin}")
        rows = 128 if b == BATCH else b
        for sym in ("max", "sum"):
            tail = lambda v: chain_tail_reference(  # noqa: E731
                v, layers[2], sym_op=sym)
            full = lambda v: chain_pool_reference(  # noqa: E731
                v, layers, sym_op=sym)
            got = chain_tail(h2, layers[2], sym_op=sym)
            e_t, bad_t = _close(got, _chunked(torch, tail, h2, rows),
                                "chain_pool layer 3")
            got = chain_pool(x, layers, sym_op=sym)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"chain_pool {b}x{n}x{cin} {sym}: non-finite output")
            e_c, bad_c = _close(got, _chunked(torch, full, x, rows),
                                "chain_pool")
            err["chain_pool"] = max(err["chain_pool"], e_t)
            err["chain"] = max(err["chain"], e_c)
            print(f"[kernel] chain_pool B={b} n={n} cin={cin} {sym}: layer 3 "
                  f"vs plain max_abs_err {e_t:.3e}, {bad_t} outside; whole "
                  f"chain vs plain {e_c:.3e}, {bad_c} outside (rtol 1e-4, "
                  f"atol 1e-4*max|ref|)")
            check(bad_t == 0 and bad_c == 0,
                  f"chain_pool disagrees with its plain version: B={b} n={n} "
                  f"cin={cin} {sym}")
        if b not in (64, BATCH):
            continue
        # max pool, as the query path runs it; the plain chain and layer 3
        # in row chunks at the query batch, whole at batch 64
        iters, p_iters = (5, 2) if b == BATCH else (20, 20)
        t = {
            "chain": _events_ms(torch, lambda: chain_pool(x, layers), iters),
            "head": _events_ms(torch, lambda: chain_head(x, layers[:2]),
                               iters),
            "tail": _events_ms(torch, lambda: chain_tail(h2, layers[2]),
                               iters),
            "chain_plain": _events_ms(torch, lambda: _chunked(
                torch, lambda v: chain_pool_reference(v, layers), x, rows),
                p_iters),
            "head_plain": _events_ms(torch, lambda: chain_head_reference(
                x, layers[:2]), p_iters),
            "tail_plain": _events_ms(torch, lambda: _chunked(
                torch, lambda v: chain_tail_reference(v, layers[2]), h2,
                rows), p_iters),
        }
        times[(b, cin, n)] = t
        f_head, _ = _head_cost(b, n, cin)
        f_tail, _ = _tail_cost(b, n)
        print(f"[kernel] chain_pool B={b} cin={cin} n={n} max: chain "
              f"{t['chain']:.4f} ms ({(f_head + f_tail) / t['chain'] / 1e9:.1f}"
              f" TFLOP/s) vs plain {t['chain_plain']:.4f} ms; chain_head "
              f"{t['head']:.4f} ms ({f_head / t['head'] / 1e9:.1f}) vs plain "
              f"{t['head_plain']:.4f}; layer 3 {t['tail']:.4f} ms "
              f"({f_tail / t['tail'] / 1e9:.1f}) vs plain "
              f"{t['tail_plain']:.4f}")
        del x, h2
    res = {"err": err}
    for b in (64, BATCH):
        tot = {k: sum(cnt * times[(b, cin, n)][k]
                      for cin, n, cnt in CHAIN_SITES)
               for k in times[(b, CHAIN_SITES[0][0], CHAIN_SITES[0][1])]}
        head_cost = [sum(cnt * _head_cost(b, n, cin)[i]
                         for cin, n, cnt in CHAIN_SITES) for i in (0, 1)]
        tail_cost = [sum(cnt * _tail_cost(b, n)[i]
                         for cin, n, cnt in CHAIN_SITES) for i in (0, 1)]
        flop = head_cost[0] + tail_cost[0]
        bound = flop / PEAK_FLOPS * 1e3
        print(f"[kernel] five chains of one B={b} forward (max): "
              f"{tot['chain']:.4f} ms, {flop / tot['chain'] / 1e9:.1f} "
              f"TFLOP/s, {bound / tot['chain']:.1%} of the {bound:.3f} ms "
              f"bound; chain_head {tot['head']:.4f} ms, layer 3 "
              f"{tot['tail']:.4f} ms; plain {tot['chain_plain']:.4f} ms")
        res[b] = dict(tot, head_cost=head_cost, tail_cost=tail_cost)
    return res


def phase_tail_kernels(torch, device):
    """pooled_tail at the three conv3-tail shapes of a batch-1000 train
    forward, a ragged case with ties and a ragged column tile (each run
    twice, bit-identical), mlp_maxpool at MLP_SHAPES."""
    from points2surf_tpu_torch.ops.kernels.mlp_maxpool import (
        mlp_maxpool, mlp_maxpool_reference)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions, pooled_tail_reductions_reference)

    gen = torch.Generator().manual_seed(SEED + 2)
    names = ("cmax", "amax", "cmin", "amin", "rsum", "rsq")
    tail = {"max_abs_err": 0.0}
    times = {}
    cases = [(TRAIN_BATCH, n, NET) for n, _ in TAIL_SITES] + [
        (37, 129, NET), (64, 300, 1000)]
    for b, n, cout in cases:
        # post-relu activations, as conv3 receives them
        x = torch.relu(torch.randn((b, n, 128), generator=gen)).to(device)
        if b != TRAIN_BATCH:
            x[:, 100:] = x[:, :1]  # tied rows: the first index must win
        w = (torch.randn((128, cout), generator=gen) / 128 ** 0.5).to(device)
        bias = (torch.randn((cout,), generator=gen) * 0.1).to(device)
        got = pooled_tail_reductions(x, w, bias)
        again = pooled_tail_reductions(x, w, bias)
        want = pooled_tail_reductions_reference(x, w, bias)
        torch.cuda.synchronize()
        for name, g, a in zip(names, got, again):
            check(torch.equal(g, a), f"pooled_tail {name} B={b} n={n} "
                                     f"C={cout}: a rerun differs")
        del again
        bad, err = 0, 0.0
        for name, g, r in zip(names, got, want):
            if g.dtype == torch.int32:
                check(bool(((g >= 0) & (g < n)).all()),
                      f"pooled_tail {name} out of range")
                continue
            e, nb = _close(g, r, f"pooled_tail {name}")
            err, bad = max(err, e), bad + nb
        del want
        # the arg contract: the value at the kernel's index is the pool
        c = torch.matmul(x, w) + bias
        for v, a in ((got[0], got[1]), (got[2], got[3])):
            at = torch.gather(c, 1, a.long()[:, None, :])[:, 0]
            e, nb = _close(at, v, "pooled_tail value at arg")
            err, bad = max(err, e), bad + nb
        del c
        if b != TRAIN_BATCH:
            check(bool((got[1] < 100).all()) and bool((got[3] < 100).all()),
                  "pooled_tail: a tie did not keep the first index")
        tail["max_abs_err"] = max(tail["max_abs_err"], err)
        msg = (f"[kernel] pooled_tail B={b} n={n} 128->{cout}: max_abs_err "
               f"{err:.3e} (rtol 1e-4, atol 1e-4*max|ref|), {bad} outside, "
               f"rerun bit-identical")
        if b == TRAIN_BATCH:
            t_k = _events_ms(torch, lambda: pooled_tail_reductions(
                x, w, bias), 10)
            t_p = _events_ms(torch, lambda: pooled_tail_reductions_reference(
                x, w, bias), 5)
            times[n] = (t_k, t_p)
            flop, _ = _pooled_tail_cost(b, n)
            msg += (f"; kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s),"
                    f" plain {t_p:.4f} ms")
        print(msg)
        check(bad == 0, f"pooled_tail disagrees with its plain version: "
                        f"B={b} n={n} C={cout}")
        del x, got
    tail["ms"] = sum(cnt * times[n][0] for n, cnt in TAIL_SITES)
    tail["plain_ms"] = sum(cnt * times[n][1] for n, cnt in TAIL_SITES)
    tail["cost"] = [sum(cnt * _pooled_tail_cost(TRAIN_BATCH, n)[i]
                        for n, cnt in TAIL_SITES) for i in (0, 1)]
    bound, _ = _bound(*tail["cost"])
    _card_state("kernel")
    print(f"[kernel] five conv3 tails of one B={TRAIN_BATCH} train forward: "
          f"kernel {tail['ms']:.4f} ms, "
          f"{tail['cost'][0] / tail['ms'] / 1e9:.1f} TFLOP/s, "
          f"{bound / tail['ms']:.1%} of the {bound:.3f} ms bound; plain "
          f"{tail['plain_ms']:.4f} ms")

    mlp = {"max_abs_err": 0.0}
    dgen = torch.Generator(device=device).manual_seed(SEED + 4)
    for b, n, cin, cout in MLP_SHAPES:
        x = torch.randn((b, n, cin), generator=dgen, device=device)
        w = torch.randn((cin, cout), generator=dgen, device=device) * 0.1
        c = torch.randn((cout,), generator=dgen, device=device)
        got = mlp_maxpool(x, w, c)
        want = mlp_maxpool_reference(x, w, c)
        torch.cuda.synchronize()
        err, bad = _close(got, want, "mlp_maxpool")
        del want
        mlp["max_abs_err"] = max(mlp["max_abs_err"], err)
        # the small shapes take tens of microseconds per call
        iters = 200 if b * n < 100_000 else 5
        t_k = _events_ms(torch, lambda: mlp_maxpool(x, w, c), iters)
        t_p = _events_ms(torch, lambda: mlp_maxpool_reference(x, w, c),
                         iters)
        if (b, n) == MLP_SHAPES[1][:2]:
            mlp["ms"], mlp["plain_ms"] = t_k, t_p
        flop = 2.0 * b * n * cin * cout
        print(f"[kernel] mlp_maxpool B={b} n={n} {cin}->{cout}: max_abs_err "
              f"{err:.3e} (rtol 1e-4, atol 1e-4*max|ref|), {bad} outside; "
              f"kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain "
              f"{t_p:.4f} ms ({flop / t_p / 1e9:.1f} TFLOP/s)")
        check(bad == 0, f"mlp_maxpool disagrees with its plain version: "
                        f"B={b} n={n}")
        del x, got
    return tail, mlp


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
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
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
    chain_head.launches = 0
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
    launches = {"chain_pool": chain_pool.launches,
                "chain_head": chain_head.launches}
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
    print(f"[main] chain_pool launches {launches['chain_pool']}, chain_head "
          f"launches {launches['chain_head']} over {n_batches} batches "
          f"(expected {5 * n_batches} each)")
    _card_state("main")
    print(f"[main] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, count in launches.items():
        check(count == 5 * n_batches,
              f"{name} was not launched five times per forward")
    _profile(torch, lambda i: fn(pts_t, batch_queries(i), n, gen),
             PROFILE_BATCHES, "main")
    return launches


def _profile(torch, step, count: int, tag: str) -> None:
    """Device time by kernel name and the device's idle share over `count`
    steady calls of step(i), from a torch.profiler trace (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(count):
            step(i + 1)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"[{tag}] profile: no device events in the trace (not "
              f"measured)")
        return
    busy, end, by_name = 0.0, spans[0][0], {}
    for t0, t1, name in spans:  # union of the device intervals
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    span = end - spans[0][0]
    print(f"[{tag}] profile of {count} calls: device busy {busy / 1e3:.3f} "
          f"ms of a {span / 1e3:.3f} ms span, idle {1 - busy / span:.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {us / count / 1e3:9.3f} ms per call "
              f"({us / busy:6.1%}) {name[:90]}")


def _train_cfg():
    from points2surf_tpu_torch.ops.patches import PatchConfig

    # bench.py's training extraction: full candidate depth (decimation 8)
    return PatchConfig(points_per_patch=300, patch_radius=0.0,
                       sub_sample_size=1000)


def phase_train_slice(torch, np, device, model, pts_pad, n, queries):
    """One fused train step on the GPU against the same step on the CPU in
    float64, from the same weights, momentum buffers, draws and rotations.

    The CPU runs the same code in float64 (the plain versions take any
    float type), which makes it the exact reference: in float32 the CPU
    step is the less accurate one on this path (on an H100 host, in the
    global encoder's first layers: GPU vs CPU float32 5.8e-3 of max|g|,
    GPU vs CPU float64 1.7e-5, CPU float32 vs float64 5.8e-3).

    Two implementations can also order near-ties differently, and the step
    has two places where order is data: the patch and sub-sample rows
    (neighbours at nearly equal distances), and the max pools' arg decisions
    (a flipped arg routes one row's gradient elsewhere). So the extractions
    are compared as point sets, and the CPU step then trains on the GPU's
    batch; the GPU step records the kernel's arg indices, and the CPU step's
    plain tail uses them after checking that each is an arg of the CPU's own
    values (the value at it is the CPU's max or min within rtol 1e-4 / atol
    1e-4 * max|c|).

    The last layer of every spatial transformer starts at zero (their output
    is then exactly the identity, as STNs are commonly initialized): at a
    random init each transformer multiplies the rounding differences between
    the two devices about tenfold (3e-5 of max|x| at the encoder tails,
    against 1e-6 with identity transformers), and the gradients then differ
    by up to ~10%. Gradients still flow through every transformer."""
    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.models.pointnet import _STNTrunk
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions_reference)
    from points2surf_tpu_torch.ops.patches import TrainDraws, draw_batch
    from points2surf_tpu_torch.train.trainer import make_train_step

    cfg = _train_cfg()
    b = SLICE_TRAIN_BATCH
    rs = np.random.RandomState(SEED + 3)
    q = torch.from_numpy(queries[:b])
    gt = torch.from_numpy((rs.randn(b) * 0.05).astype(np.float32))
    draws = draw_batch(torch.Generator().manual_seed(SEED + 3), b,
                       pts_pad.shape[0], cfg, train=True)
    model = copy.deepcopy(model)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    names = [k for k, _ in model.named_parameters()]
    momentum = {k: torch.from_numpy((rs.randn(*p.shape) * 1e-3).astype(
        np.float32)) for k, p in model.named_parameters()}
    real = pn.pooled_tail_reductions
    recorded = []
    stats = {"args": 0, "own_arg_differs": 0, "bad_args": 0}

    def record(x, w, bias):
        out = real(x, w, bias)
        recorded.append((out[1].cpu(), out[3].cpu()))
        return out

    def replay(x, w, bias):
        cmax, amax, cmin, amin, rsum, rsq = (
            pooled_tail_reductions_reference(x, w, bias))
        gmax, gmin = recorded.pop(0)
        c = torch.matmul(x, w) + bias
        tol = 1e-4 * float(c.abs().max())
        pooled = []
        for own, val, g in ((amax, cmax, gmax), (amin, cmin, gmin)):
            at = torch.gather(c, 1, g.long()[:, None, :])[:, 0]
            stats["args"] += g.numel()
            stats["own_arg_differs"] += int((own != g).sum())
            stats["bad_args"] += int(((at - val).abs()
                                      > tol + 1e-4 * val.abs()).sum())
            pooled.append(at)
        return pooled[0], gmax, pooled[1], gmin, rsum, rsq

    res, batches = [], []
    f64 = torch.float64
    for dev, dtype, hook in ((device, torch.float32, record),
                             (torch.device("cpu"), f64, replay)):
        m = copy.deepcopy(model).to(device=dev, dtype=dtype)
        steps = make_train_step(m, OUTPUTS, lr=0.01, momentum=0.9,
                                patch_cfg=cfg)
        steps.load_sgd_state(momentum, None)
        d = TrainDraws(draws.offset.to(dev), draws.logu.to(dev, dtype),
                       draws.rot.to(dev, dtype))
        pn.pooled_tail_reductions = hook
        try:
            t0 = time.perf_counter()
            batch = steps.extract_train_batch(
                torch.from_numpy(pts_pad).to(dev, dtype), q.to(dev, dtype),
                n, gt.to(dev, dtype), d)
            batches.append({k: v.cpu() for k, v in batch.items()})
            if dtype == f64:  # the GPU's rows, in the GPU's order
                batch = {k: v.to(f64) if v.is_floating_point() else v
                         for k, v in batches[0].items()}
            losses, metrics = steps.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            pn.pooled_tail_reductions = real
        print(f"[train-slice] {dev.type} {str(dtype)[6:]} step at batch {b}: "
              f"{dt:.2f} s")
        named = dict(m.named_parameters())
        res.append({
            "losses": losses.cpu().to(f64),
            "metrics": {k: v.cpu().to(f64) for k, v in metrics.items()},
            "grads": {k: named[k].grad.cpu().to(f64) for k in names},
            "state": {k: v.cpu().to(f64) for k, v in m.state_dict().items()},
        })
        del m, steps
    check(not recorded, "the CPU step ran fewer pooled tails than the GPU")
    for k in ("patch_pts_ps", "pts_sub_sample_ms"):
        e = float((_sorted_points(torch, batches[0][k].to(f64))
                   - _sorted_points(torch, batches[1][k])).abs().max())
        print(f"[train-slice] extraction {k} {tuple(batches[1][k].shape)} "
              f"GPU vs CPU as point sets: max_abs_err {e:.3e} (atol 1e-5)")
        check(e <= 1e-5, f"train extraction {k} differs between GPU and CPU")
    for k in ("patch_radius_ms", "imp_surf_query_point_ms"):
        e = float((batches[0][k].to(f64) - batches[1][k]).abs().max())
        print(f"[train-slice] extraction {k} GPU vs CPU max_abs_err {e:.3e}")
        check(e <= 1e-5, f"train extraction {k} differs between GPU and CPU")
    g, c = res
    print(f"[train-slice] arg decisions {stats['args']}: the GPU's index is "
          f"not the CPU's own first arg in {stats['own_arg_differs']} "
          f"(near-ties), and not an arg of the CPU values in "
          f"{stats['bad_args']}")
    check(stats["bad_args"] == 0, "a GPU arg index is not an arg on the CPU")
    check(bool(torch.isfinite(g["losses"]).all()), "non-finite train loss")
    err = float(((g["losses"] - c["losses"]).abs()
                 / c["losses"].abs()).max())
    print(f"[train-slice] losses GPU {g['losses'].tolist()} CPU "
          f"{c['losses'].tolist()}: max rel err {err:.3e} (rtol 1e-4)")
    check(err <= 1e-4, "train losses differ between GPU and CPU")
    for k, v in c["metrics"].items():
        w = g["metrics"][k]
        same = bool(torch.isclose(w, v, rtol=1e-4, atol=0.0, equal_nan=True))
        print(f"[train-slice] metric {k}: GPU {w.item():.6f} CPU "
              f"{v.item():.6f}")
        check(same, f"train metric {k} differs between GPU and CPU")
    g_max = max(float(t.abs().max()) for t in c["grads"].values())
    worst, bad_tensors = (0.0, ""), []
    for k in names:
        gg, cg = g["grads"][k], c["grads"][k]
        scale = float(cg.abs().max())
        if scale < 1e-6 * g_max:  # zero in exact arithmetic
            if float(gg.abs().max()) >= 1e-6 * g_max:
                bad_tensors.append(k)
            continue
        e = (gg - cg).abs()
        worst = max(worst, (float(e.max()) / scale, k))
        if bool((e > 1e-3 * scale + 1e-3 * cg.abs()).any()):
            bad_tensors.append(k)
    print(f"[train-slice] gradients of {len(names)} tensors: worst max|err| "
          f"/ max|g| {worst[0]:.3e} ({worst[1]}); {len(bad_tensors)} outside "
          f"rtol 1e-3 / atol 1e-3*max|g| {bad_tensors[:5]}")
    check(not bad_tensors, "gradients differ between GPU and CPU")
    bad_state, worst = [], 0.0
    for k, v in c["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        e = (g["state"][k] - v).abs()
        worst = max(worst, float(e.max()))
        if bool((e > 1e-6 + 1e-4 * v.abs()).any()):
            bad_state.append(k)
    print(f"[train-slice] updated parameters and running statistics: max abs "
          f"err {worst:.3e}; {len(bad_state)} tensors outside rtol 1e-4 / "
          f"atol 1e-6 {bad_state[:5]}")
    check(not bad_state, "updated state differs between GPU and CPU")


def phase_train_throughput(torch, np, device, model, pts_pad, n, queries):
    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.train.trainer import make_train_step

    model = copy.deepcopy(model).to(device)
    steps = make_train_step(model, OUTPUTS, lr=0.01, momentum=0.9,
                            patch_cfg=_train_cfg())
    pts_t = torch.from_numpy(pts_pad).to(device)
    q_all = torch.from_numpy(queries).to(device)
    gt = torch.from_numpy((np.random.RandomState(SEED).randn(TRAIN_BATCH)
                           * 0.05).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def batch_queries(i):
        s = (i * TRAIN_BATCH) % (len(queries) - TRAIN_BATCH)
        return q_all[s:s + TRAIN_BATCH]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pooled_tail_reductions.launches = 0
    chain_pool.launches = 0
    for i in range(TRAIN_WARMUP):
        losses, _ = steps.train_step_fused(pts_t, batch_queries(i), n, gt,
                                           gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        losses, _ = steps.train_step_fused(pts_t, batch_queries(i), n, gt,
                                           gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(losses).all()), "non-finite train loss")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
          for _ in range(TRAIN_SPLIT)]
    for j in range(TRAIN_SPLIT):
        q = batch_queries(TRAIN_WARMUP + TRAIN_TIMED + j)
        ev[j][0].record()
        batch = steps.extract_train_batch(pts_t, q, n, gt, gen)
        ev[j][1].record()
        loss_list, _ = steps.forward_loss(batch)
        ev[j][2].record()
        steps.backward(loss_list)
        ev[j][3].record()
        steps.update()
        ev[j][4].record()
    torch.cuda.synchronize()
    launches = pooled_tail_reductions.launches
    n_steps = TRAIN_WARMUP + TRAIN_TIMED + TRAIN_SPLIT
    split = [sum(e[s].elapsed_time(e[s + 1]) for e in ev) / TRAIN_SPLIT
             for s in range(4)]
    pps = TRAIN_BATCH * TRAIN_TIMED / dt
    print(f"[train] {pps:.1f} train patches/s at batch {TRAIN_BATCH}, f32 "
          f"({TRAIN_TIMED} timed steps, {dt / TRAIN_TIMED * 1e3:.2f} ms/step "
          f"host clock); last losses {losses.tolist()}")
    print(f"[train] stage split per step (CUDA events, mean of "
          f"{TRAIN_SPLIT}): extraction {split[0]:.2f} ms, forward+loss "
          f"{split[1]:.2f} ms, backward {split[2]:.2f} ms, optimizer "
          f"{split[3]:.2f} ms")
    print(f"[train] pooled_tail launches {launches} over {n_steps} steps "
          f"(expected {5 * n_steps}); chain_pool launches "
          f"{chain_pool.launches} (train mode runs no eval chain)")
    print(f"[train] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(launches == 5 * n_steps,
          "pooled_tail was not launched five times per train step")
    _card_state("train")
    _profile(torch, lambda i: steps.train_step_fused(
        pts_t, batch_queries(i), n, gt, gen), TRAIN_PROFILE, "train")
    return launches


def _watertight(np, faces) -> bool:
    """Every undirected edge of the mesh belongs to exactly two faces."""
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e[:, 0] * (int(faces.max()) + 1) + e[:, 1],
                          return_counts=True)
    return bool((counts == 2).all())


def phase_mesh(torch, np, device, cfg, model, pts, pts_pad, n):
    """Seconds per 256^3 mesh by bench.py's recipe (bench_mesh), through the
    port: grid-256 queries, the query sweep at batch BATCH (the last batch
    padded with its first query), the proxy sign over the sweep's
    magnitudes (random weights predict one sign), the volume on the card,
    an f32 fetch and the C++ marching. One warm-up pass, MESH_PASSES timed
    passes, the faster reported. Then: the GPU volume equals the CPU volume
    bit for bit (seed filter 0 and 4), the mesh is watertight, marching
    reruns byte-identically, and the single-shape and directory entry
    points write the same mesh from the card."""
    import tempfile

    from points2surf_tpu_torch.infer import meshing
    from points2surf_tpu_torch.infer.query import (
        drain_batched_results, make_sdf_query_fn)
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.marching_cubes import extract_isosurface
    from points2surf_tpu_torch.ops.voxel import grid_query_points

    fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=False)
    pts_t = torch.from_numpy(pts_pad).to(device)
    center = pts.mean(0)
    r_mean = float(np.linalg.norm(pts - center, axis=1).mean())
    args = (MESH_GRID, MESH_SIGMA, MESH_CERTAINTY)

    def one_mesh(i):
        gen = torch.Generator(device=device).manual_seed(SEED + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        queries = grid_query_points(pts, MESH_GRID, 3, device=device)
        t1 = time.perf_counter()
        nq = len(queries)
        q_all = torch.from_numpy(queries).to(device)
        pending = []
        for s in range(0, nq, BATCH):
            q = q_all[s:s + BATCH]
            if len(q) < BATCH:
                q = torch.cat([q, q[:1].expand(BATCH - len(q), 3)])
            pending.append(fn(pts_t, q, n, gen))
        dists = drain_batched_results(pending, nq)
        dists = np.sign(
            r_mean - np.linalg.norm(queries - center, axis=1)
        ).astype(np.float32) * np.maximum(np.abs(dists), 1e-4)
        t2 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        stats = {}
        q_dev = torch.from_numpy(queries).to(device)
        d_dev = torch.from_numpy(dists).to(device)
        ev[0].record()
        vol_dev = meshing._build_volume(q_dev, d_dev, nq, *args, 0, stats)
        ev[1].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        vol = vol_dev.cpu().numpy()
        t4 = time.perf_counter()
        v, f = extract_isosurface(vol, 0.0)
        t5 = time.perf_counter()
        r = {"total": t5 - t0, "grid": t1 - t0, "sweep": t2 - t1,
             "volume": t3 - t2, "volume_events": ev[0].elapsed_time(ev[1]),
             "fetch": t4 - t3, "marching": t5 - t4, "rounds": stats["rounds"],
             "queries": nq, "batches": len(pending), "verts": len(v),
             "faces": len(f),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        return r, queries, dists, vol, v, f

    chain_pool.launches = 0
    chain_head.launches = 0
    runs = []
    for i in range(1 + MESH_PASSES):
        r, queries, dists, vol, v, f = one_mesh(i)
        tag = "warm-up" if i == 0 else f"pass {i}"
        print(f"[mesh] {tag}: {r['total']:.3f} s per {MESH_GRID}^3 mesh = "
              f"grid queries {r['grid']:.3f} + sweep {r['sweep']:.3f} "
              f"({r['queries']} queries, {r['batches']} batches of {BATCH}) "
              f"+ volume {r['volume']:.3f} (device {r['volume_events']:.1f} "
              f"ms by CUDA events, {r['rounds']} propagation rounds) + "
              f"fetch {r['fetch']:.3f} + marching {r['marching']:.3f}; "
              f"{r['verts']} vertices, {r['faces']} faces; peak "
              f"{r['peak_gib']:.3f} GiB")
        if i:
            runs.append(r)
    launches = {"chain_pool": chain_pool.launches,
                "chain_head": chain_head.launches}
    best = min(runs, key=lambda r: r["total"])
    print(f"[mesh] {best['total']:.3f} s per {MESH_GRID}^3 mesh (faster of "
          f"{MESH_PASSES} timed passes); chain_pool launches "
          f"{launches['chain_pool']}, chain_head launches "
          f"{launches['chain_head']} over {1 + MESH_PASSES} meshes (expected "
          f"{5 * best['batches'] * (1 + MESH_PASSES)} each)")
    _card_state("mesh")
    for name, count in launches.items():
        check(count == 5 * best["batches"] * (1 + MESH_PASSES),
              f"{name} was not launched five times per sweep batch")
    check(len(v) > 0 and len(f) > 0, "marching produced no surface")
    check(bool(np.isfinite(v).all()), "non-finite mesh vertices")
    check(_watertight(np, f), "the mesh is not watertight")
    v2, f2 = extract_isosurface(vol, 0.0)
    same = v2.tobytes() == v.tobytes() and f2.tobytes() == f.tobytes()
    print(f"[mesh] watertight (every edge in two faces); a second marching "
          f"of the volume byte-identical: {same}")
    check(same, "a second marching of the same volume differs")

    q_dev = torch.from_numpy(queries).to(device)
    d_dev = torch.from_numpy(dists).to(device)
    _profile(torch, lambda i: meshing._build_volume(
        q_dev, d_dev, len(queries), *args), 1, "mesh volume")
    cpu = torch.device("cpu")
    for sf in (0, 4):
        t0 = time.perf_counter()
        stats_c, stats_g = {}, {}
        want = meshing._build_volume(torch.from_numpy(queries),
                                     torch.from_numpy(dists), len(queries),
                                     *args, sf, stats_c)
        t_cpu = time.perf_counter() - t0
        got = meshing._build_volume(q_dev, d_dev, len(queries), *args, sf,
                                    stats_g).to(cpu)
        equal = torch.equal(got, want)
        print(f"[mesh] seed_filter {sf}: GPU volume equals the CPU volume bit "
              f"for bit: {equal} ({stats_g['rounds']} rounds on the GPU, "
              f"{stats_c['rounds']} on the CPU; CPU build {t_cpu:.2f} s on "
              f"{torch.get_num_threads()} threads)")
        check(equal, f"GPU and CPU volumes differ (seed_filter {sf})")
        if sf == 0:
            check(torch.equal(got, torch.from_numpy(vol)),
                  "the timed pass's volume differs from a rebuild")
    del q_dev, d_dev

    with tempfile.TemporaryDirectory() as tmp:
        single = os.path.join(tmp, "single.ply")
        t0 = time.perf_counter()
        ok = meshing.implicit_surface_to_mesh(
            dists, queries, os.path.join(tmp, "single.off"), single, *args,
            device=device)
        t_single = time.perf_counter() - t0
        check(ok and os.path.getsize(single) > 0
              and os.path.getsize(os.path.join(tmp, "single.off")) > 0,
              "implicit_surface_to_mesh wrote no mesh")
        dirs = [os.path.join(tmp, d) for d in ("dist", "pts", "vol", "mesh")]
        for d in dirs[:2]:
            os.makedirs(d)
        for name, dist in (("shape", dists),
                           ("zeros", np.zeros_like(dists))):
            np.save(os.path.join(dirs[0], f"{name}.xyz.npy"), dist)
            np.save(os.path.join(dirs[1], f"{name}.xyz.npy"), queries)
        t0 = time.perf_counter()
        meshing.implicit_surface_to_mesh_directory(
            *dirs, *args, seed_filter=0, device=device)
        t_dir = time.perf_counter() - t0
        written = sorted(os.listdir(dirs[3]))
        check(written == ["shape.ply"],
              f"the directory driver wrote {written}, not one mesh")
        with open(single, "rb") as a, open(os.path.join(
                dirs[3], "shape.ply"), "rb") as b:
            same = a.read() == b.read()
        print(f"[mesh] implicit_surface_to_mesh on the card wrote .ply and "
              f".off ({t_single:.2f} s with the debug OFF); the directory "
              f"driver wrote {written} ({t_dir:.2f} s, all-zeros shape "
              f"skipped), byte-identical to the single path's: {same}")
        check(same, "the directory driver's mesh differs from the single "
                    "path's")
    return best, launches


class _Recorder:
    """Wraps the model's kernel calls (``models/pointnet.chain_pool`` and
    ``pooled_tail_reductions``) during phase 8 and keeps a copy of the
    inputs of the first call at each distinct call site (shape, pool), to
    hold the kernels against their plain versions afterwards. The wrapped
    calls launch and count as usual."""

    def __init__(self, pn):
        self.pn = pn
        self.real = (pn.chain_pool, pn.pooled_tail_reductions)
        self.chain, self.tail = {}, {}

    def __enter__(self):
        real_chain, real_tail = self.real

        def chain(x, layers, *, sym_op="max", relu_last=False):
            key = (tuple(x.shape), sym_op, relu_last, layers[2][0].shape[1])
            if key not in self.chain:
                self.chain[key] = (x.clone(), tuple(
                    tuple(t.clone() for t in layer) for layer in layers))
            return real_chain(x, layers, sym_op=sym_op, relu_last=relu_last)

        def tail(x, w, b):
            key = (tuple(x.shape), w.shape[1])
            if key not in self.tail:
                self.tail[key] = (x.detach().clone(), w.detach().clone(),
                                  b.detach().clone())
            return real_tail(x, w, b)

        self.pn.chain_pool, self.pn.pooled_tail_reductions = chain, tail
        return self

    def __exit__(self, *exc):
        self.pn.chain_pool, self.pn.pooled_tail_reductions = self.real


def _driver_sites_check(torch, rec, tag):
    """Each kernel against its plain version at the call sites ``rec``
    recorded in phase 8 (PERF.md §2 tolerances). Returns the max abs error
    per kernel."""
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_head_reference, chain_tail, chain_tail_reference)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions, pooled_tail_reductions_reference)

    err = {"chain_head": 0.0, "chain_pool": 0.0, "pooled_tail": 0.0}
    for (shape, sym, relu_last, cout), (x, layers) in sorted(
            rec.chain.items()):
        h2 = chain_head(x, layers[:2])
        e_h, bad_h = _close(h2, chain_head_reference(x, layers[:2]),
                            "chain_head")
        got = chain_tail(h2, layers[2], sym_op=sym, relu_last=relu_last)
        e_t, bad_t = _close(got, chain_tail_reference(
            h2, layers[2], sym_op=sym, relu_last=relu_last), "chain_pool")
        print(f"[{tag}] call site B={shape[0]} n={shape[1]} cin={shape[2]} "
              f"-> {cout} {sym}: chain_head max_abs_err {e_h:.3e} ({bad_h} "
              f"outside), chain_pool {e_t:.3e} ({bad_t} outside; rtol 1e-4, "
              f"atol 1e-4*max|ref|)")
        check(bad_h == 0 and bad_t == 0, f"a chain kernel disagrees with its "
                                         f"plain version at {shape} {sym}")
        err["chain_head"] = max(err["chain_head"], e_h)
        err["chain_pool"] = max(err["chain_pool"], e_t)
    for (shape, cout), (x, w, b) in sorted(rec.tail.items()):
        got = pooled_tail_reductions(x, w, b)
        want = pooled_tail_reductions_reference(x, w, b)
        bad, e = 0, 0.0
        for g, r in zip(got, want):
            if g.dtype == torch.int32:
                continue
            e_i, bad_i = _close(g, r, "pooled_tail")
            e, bad = max(e, e_i), bad + bad_i
        c = torch.matmul(x, w) + b
        for v, a in ((got[0], got[1]), (got[2], got[3])):
            at = torch.gather(c, 1, a.long()[:, None, :])[:, 0]
            e_i, bad_i = _close(at, v, "pooled_tail value at arg")
            e, bad = max(e, e_i), bad + bad_i
        print(f"[{tag}] call site B={shape[0]} n={shape[1]} 128->{cout}: "
              f"pooled_tail max_abs_err {e:.3e}, {bad} outside (the value at "
              f"each arg index included)")
        check(bad == 0, f"pooled_tail disagrees with its plain version at "
                        f"{shape}")
        err["pooled_tail"] = max(err["pooled_tail"], e)
        del c, got, want
    return err


def _mixed_batch_check(torch, np, device, pn, train_opt, model_file, tmp):
    """One full-width train step on a batch gathered from two shapes: the
    plain step after ``PatchPipeline._assemble``'s gather, which
    abc_minimal's shape-consecutive plan never makes. Its five tails launch
    and hold against their plain version. Returns the max abs errors."""
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.train.trainer import Trainer

    opt = argparse.Namespace(**{**vars(train_opt), "refine": model_file,
                                "outdir": os.path.join(tmp, "mixed")})
    tr = Trainer(opt, device=device)
    n0 = tr.train_store.shape_patch_count[0]
    chunk = np.arange(n0 - DRIVER_BATCH // 2, n0 + DRIVER_BATCH // 2)
    batch = tr.train_pipe._assemble(chunk, True)
    pooled_tail_reductions.launches = 0
    with _Recorder(pn) as rec:
        losses, _ = tr.steps.train_step(batch)
    torch.cuda.synchronize()
    launched = pooled_tail_reductions.launches
    print(f"[driver mixed] a train step on patches {chunk[0]}-{chunk[-1]} "
          f"(two shapes, {DRIVER_BATCH // 2} each, gathered by one "
          f"index_select): losses {losses.tolist()}, pooled_tail launches "
          f"{launched}")
    check(launched == 5 and bool(torch.isfinite(losses).all()),
          "the mixed-batch train step did not launch pooled_tail 5 times or "
          "its losses are not finite")
    err = _driver_sites_check(torch, rec, "driver mixed")
    check(len(rec.tail) >= 2, f"the mixed step reached {len(rec.tail)} tail "
                              f"call sites, expected 2")
    return err


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _evaluator_card_vs_cpu(torch, np, device, evaluator, data, models, tmp,
                           test_name, val_name, queries):
    """``points_to_surf_eval`` itself (batching, the padded last batch, the
    order of draws, one fetch per shape, the writer) on the card and on the
    CPU, with one CPU generator's draws moved to each device, over the first
    1.5 batches of the test shape's grid queries (reconstruction) and of
    the val shape's GT queries (the augmented eval pass). The written
    distances must agree at rtol 1e-3 / atol 1e-4 with no sign flip."""
    import shutil

    from points2surf_tpu_torch.cli import eval_args

    n_q = DRIVER_BATCH + DRIVER_BATCH // 2
    root = os.path.join(tmp, "first_batches")
    for sub in ("04_pts", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, sub))
    for name in (test_name, val_name):
        shutil.copy(os.path.join(data, "04_pts", name + ".xyz.npy"),
                    os.path.join(root, "04_pts"))
    for sub in ("05_query_pts", "05_query_dist"):
        np.save(os.path.join(root, sub, val_name + ".ply.npy"), np.load(
            os.path.join(data, sub, val_name + ".ply.npy"))[:n_q])
    for split, name in (("testset", test_name), ("valset", val_name)):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write(name + "\n")
    # the first grid queries as the store's disk cache, newer than the cloud
    cache = os.path.join(root, "cache", f"grid_queries_r{DRIVER_GRID}_e3",
                         test_name + ".npy")
    os.makedirs(os.path.dirname(cache))
    np.save(cache, queries[:n_q])
    t_pts = os.path.getmtime(os.path.join(root, "04_pts",
                                          test_name + ".xyz.npy"))
    os.utime(cache, (t_pts + 10, t_pts + 10))

    common = ["--indir", root, "--models", "vanilla", "--modeldir", models,
              "--batchSize", str(DRIVER_BATCH), "--cache_capacity", "5"]
    real_draw = evaluator.draw_batch
    outs = {}
    try:
        for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
            gen = torch.Generator().manual_seed(SEED + 8)

            def draw(g, b, n, cfg, small_cloud=False, train=False, dev=dev,
                     gen=gen):
                d = real_draw(gen, b, n, cfg, small_cloud, train)
                return type(d)(*(t.to(dev) for t in vars(d).values()))

            evaluator.draw_batch = draw
            outs[tag] = os.path.join(tmp, "first_batches_" + tag)
            for extra in (["--dataset", "testset.txt", "--reconstruction",
                           "True", "--query_grid_resolution",
                           str(DRIVER_GRID), "--epsilon", "3"],
                          ["--dataset", "valset.txt"]):
                evaluator.points_to_surf_eval(eval_args.parse_arguments(
                    common + ["--outdir", outs[tag]] + extra), device=dev)
    finally:
        evaluator.draw_batch = real_draw
    check(_files(outs["card"]) == _files(outs["cpu"]),
          "the card's and the CPU's evaluator wrote different files")
    for what, sub in (("reconstruction", os.path.join(
            "rec", "dist_ms", test_name + ".xyz.npy")),
                      ("eval pass", os.path.join(
            "eval", "eval", val_name + ".xyz.npy"))):
        g, c = (np.load(os.path.join(outs[k], sub)) for k in ("card", "cpu"))
        check(g.shape == c.shape == (n_q,),
              f"{what}: {g.shape} and {c.shape} distances, expected {n_q}")
        e = np.abs(g - c)
        bad = int((e > 1e-4 + 1e-3 * np.abs(c)).sum())
        flips = int(((np.sign(g) != np.sign(c)) & (np.abs(c) > 1e-4)).sum())
        print(f"[driver] the evaluator's first {n_q} {what} queries (a full "
              f"batch and a padded one), card vs CPU with the same draws: "
              f"distances max_abs_err {float(e.max()):.3e}, {bad} outside "
              f"rtol 1e-3 / atol 1e-4; sign flips {flips}")
        check(bad == 0 and flips == 0,
              f"the card's evaluator differs from the CPU's ({what})")


def _csv_row(np, path, name):
    """The numbers of ``path``'s one row for shape ``name`` (the MSE CSV
    cuts names to 10 characters); fails unless there are four or more and
    all are finite."""
    with open(path) as f:
        rows = [ln.split(",") for ln in f.read().splitlines()[1:]
                if ln.strip()]
    row = [r for r in rows if name[:8] in r[0]]
    check(len(row) == 1, f"{path}: no single row for {name}")
    vals = []
    for cell in row[0]:
        try:
            vals.append(float(cell))
        except ValueError:
            pass  # a file name
    check(len(vals) >= 4 and bool(np.isfinite(vals).all()),
          f"{path}: row {row[0]} is not finite")
    return vals


def phase_driver(torch, np, device, tmp):
    """Phase 8: the port's ``full_run`` on the card (train on abc_minimal,
    eval pass and MSE CSV, reconstruction at grid 128, meshing, the
    Hausdorff/Chamfer CSV), with full_run's defaults but DRIVER_NEPOCH
    epochs, in the temporary directory ``tmp``, which gets a copy of the
    dataset and keeps the run's checkpoint for phase 9."""
    import shutil

    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.cli.full_run import STAGES, full_run
    from points2surf_tpu_torch.infer import evaluator
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.ops.patches import PatchConfig
    from points2surf_tpu_torch.train import checkpoint as ckpt
    from points2surf_tpu_torch.train.trainer import Trainer
    from points2surf_tpu_torch.utils import mesh_io

    counters = {"chain_head": chain_head, "chain_pool": chain_pool,
                "pooled_tail": pooled_tail_reductions}
    print(f"[driver] full_run: {DRIVER_DATASET}, vanilla (non-shared "
          f"transformers), net {NET}, 300 / 1000 points, batch "
          f"{DRIVER_BATCH}, 1000 patches per shape, grid {DRIVER_GRID}; "
          f"nepoch {DRIVER_NEPOCH} (full_run's default is 10; cut to fit the "
          f"time limit)")
    src = os.path.join(ROOT, "datasets", DRIVER_DATASET)
    data = os.path.join(tmp, "datasets", DRIVER_DATASET)
    shutil.copytree(src, data, ignore=shutil.ignore_patterns("cache"))
    with open(os.path.join(data, "trainset.txt")) as f:
        train_names = [ln.strip() for ln in f if ln.strip()]
    n_patches = sum(min(1000, len(np.load(os.path.join(
        data, "05_query_dist", s + ".ply.npy"), mmap_mode="r")))
        for s in train_names)
    steps_per_epoch = -(-n_patches // DRIVER_BATCH)
    times, launches = {}, {}
    clock = [0.0]

    def stage_done(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[stage] = now - clock[0]
        launches[stage] = {k: f.launches for k, f in counters.items()}
        for f in counters.values():
            f.launches = 0
        clock[0] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    clock[0] = time.perf_counter()
    with _Recorder(pn) as rec:
        csv = full_run(base_dir=os.path.join(tmp, "datasets"),
                       dataset=DRIVER_DATASET, out_root=tmp,
                       nepoch=DRIVER_NEPOCH, batch_size=DRIVER_BATCH,
                       grid_resolution=DRIVER_GRID, net_size=NET,
                       device=device, stage_done=stage_done)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(tuple(times) == STAGES, f"full_run reported stages {times}")
    res = os.path.join(tmp, "results", "vanilla", DRIVER_DATASET)
    with open(os.path.join(data, "testset.txt")) as f:
        test_name = f.read().split()[0]
    with open(os.path.join(data, "valset.txt")) as f:
        val_name = f.read().split()[0]
    queries = np.load(os.path.join(res, "rec", "query_pts_ms",
                                   test_name + ".xyz.npy"))
    dists = np.load(os.path.join(res, "rec", "dist_ms",
                                 test_name + ".xyz.npy"))
    n_val = len(np.load(os.path.join(data, "05_query_dist",
                                      val_name + ".ply.npy")))
    n_steps = DRIVER_NEPOCH * steps_per_epoch
    rec_batches = -(-len(queries) // DRIVER_BATCH)
    eval_batches = -(-n_val // DRIVER_BATCH)
    print(f"[driver] train {times['train']:.3f} s ({n_steps} steps, "
          f"{times['train'] / DRIVER_NEPOCH:.3f} s per epoch with its "
          f"interleaved test batches and checkpoints, "
          f"{n_steps * DRIVER_BATCH / times['train']:.1f} train "
          f"patches/s); eval pass {times['eval']:.3f} s ({n_val} "
          f"queries, {eval_batches} batches, with its MSE CSV); "
          f"reconstruction {times['reconstruction']:.3f} s ({len(queries)}"
          f" grid-{DRIVER_GRID} queries, {rec_batches} batches, "
          f"{len(queries) / times['reconstruction']:.1f} queries/s); "
          f"meshing {times['meshing']:.3f} s; comparison "
          f"{times['comparison']:.3f} s; peak {peak:.3f} GiB (host "
          f"clock, torch.cuda.synchronize() at each stage's end)")
    for stage in STAGES:
        print(f"[driver] launches in {stage}: " + ", ".join(
            f"{k} {v}" for k, v in launches[stage].items()))
    _card_state("driver")
    tr = launches["train"]
    check(tr["pooled_tail"] == 5 * n_steps,
          f"pooled_tail launched {tr['pooled_tail']} times in training, "
          f"not 5 per step over {n_steps} steps")
    for stage, batches in (("eval", eval_batches),
                           ("reconstruction", rec_batches)):
        for k in ("chain_head", "chain_pool"):
            check(launches[stage][k] == 5 * batches,
                  f"{k} launched {launches[stage][k]} times in {stage}, "
                  f"not 5 per batch over {batches} batches")
    check(dists.shape == (len(queries),)
          and bool(np.isfinite(dists).all()),
          "reconstruction distances not finite or of the wrong shape")
    err = _driver_sites_check(torch, rec, "driver")
    check(len(rec.chain) >= 3 and len(rec.tail) >= 2,
          f"phase 8 reached {len(rec.chain)} chain and {len(rec.tail)} "
          f"tail call sites, expected 3 and 2")

    # the checkpoint the card wrote; its key set is the one the port
    # writes on the CPU for the same options
    models = os.path.join(tmp, "models")
    model_file = os.path.join(models, "vanilla_model.npz")
    flat = ckpt.load_state(model_file)
    train_opt = ckpt.load_params_namespace(
        os.path.join(models, "vanilla_params.json"))
    cpu_keys = set(Trainer(train_opt, device="cpu").state_dict())
    check(set(flat) == cpu_keys, "the card's checkpoint keys differ from "
                                 "the CPU trainer's")
    print(f"[driver] checkpoint: {len(flat)} arrays; the key set equals "
          f"a CPU trainer's")
    mixed = _mixed_batch_check(torch, np, device, pn, train_opt,
                               model_file, tmp)
    err = {k: max(v, mixed[k]) for k, v in err.items()}
    # the CPU evaluator loads the card's checkpoint (strict)
    _evaluator_card_vs_cpu(torch, np, device, evaluator, data, models,
                           tmp, test_name, val_name, queries)

    # where a batch-100 reconstruction batch spends the card's time
    eval_opt = argparse.Namespace(
        modeldir=models, modelpostfix="_model.npz",
        parampostfix="_params.json", eval_dtype="auto")
    m_gpu, _ = evaluator.load_model_for_eval(eval_opt, "vanilla", device)
    cfg = PatchConfig(points_per_patch=train_opt.points_per_patch,
                      patch_radius=0.0,
                      sub_sample_size=train_opt.sub_sample_size,
                      subsample_candidates=
                      evaluator.EVAL_SUBSAMPLE_CANDIDATES)
    pts = np.load(os.path.join(data, "04_pts", test_name + ".xyz.npy"))
    pts_pad = np.zeros((-(-len(pts) // 16384) * 16384, 3), np.float32)
    pts_pad[:len(pts)] = pts[:, :3]
    fn = make_sdf_query_fn(m_gpu, tuple(train_opt.outputs), cfg, False)
    pts_dev = torch.from_numpy(pts_pad).to(device)
    q_dev = torch.from_numpy(queries).to(device)
    g_dev = torch.Generator(device=device).manual_seed(SEED)
    _profile(torch, lambda i: fn(
        pts_dev, q_dev[i * DRIVER_BATCH:(i + 1) * DRIVER_BATCH],
        len(pts), g_dev), DRIVER_PROFILE, "driver sweep")

    verts, faces = mesh_io.load_mesh(os.path.join(
        res, "rec", "mesh", test_name + ".ply"))
    check(len(faces) > 0 and _watertight(np, np.asarray(faces)),
          "the reconstructed mesh is missing or not watertight")
    mse = _csv_row(np, os.path.join(res, "eval", "rme_comp_res.csv"),
                   val_name)
    hd = _csv_row(np, csv, test_name)
    print(f"[driver] mesh {len(verts)} vertices, {len(faces)} faces, "
          f"watertight; eval CSV row {mse}; Hausdorff/Chamfer CSV row "
          f"{hd}")
    total = {k: sum(launches[s][k] for s in STAGES) for k in counters}
    return {"launches": total, "err": err, "times": times, "models": models,
            "test_pts_pad": pts_pad, "test_n": len(pts),
            "rec_queries": queries,
            "outputs": tuple(train_opt.outputs), "cfg": cfg}


class _Bf16Mode:
    """Sets the JAX package's variables that select the bf16-operand mode
    (``default``) of the eval chain and the train tail while it lives."""

    def __enter__(self):
        for env in BF16_ENV.values():
            os.environ[env] = "default"
        return self

    def __exit__(self, *exc):
        for env in BF16_ENV.values():
            del os.environ[env]


def _zero_launches(*fns) -> None:
    for f in fns:
        f.launches = 0
        f.launches_bf16 = 0


def phase_bf16_kernels(torch, device):
    """Phase 9, kernels: chain_head, chain_pool (layer 3) and pooled_tail in
    the bf16 mode against their plain bf16 versions at the query path's
    chain call sites (batch BATCH) and the train step's tails (batch
    TRAIN_BATCH), with times. Layer 3 takes the kernel's own bf16 h2, so it
    and its plain version see the same operands."""
    from points2surf_tpu_torch.device import round_bf16
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_head_bf16_straddles, chain_head_reference,
        chain_pool, chain_pool_reference, chain_tail, chain_tail_reference)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions, pooled_tail_reductions_reference)

    gen = torch.Generator().manual_seed(SEED + 9)
    dgen = torch.Generator(device=device).manual_seed(SEED + 10)
    err = {"chain_head": 0.0, "chain_pool": 0.0, "chain": 0.0,
           "pooled_tail": 0.0}
    res = {"err": err, "straddles": 0, "h2_elements": 0}
    times = {}
    bf = dict(bf16_operands=True)
    for cin, n, _ in CHAIN_SITES:
        x = torch.randn((BATCH, n, cin), generator=dgen, device=device)
        layers = _random_chain(torch, gen, cin, device)
        h2 = chain_head(x, layers[:2], **bf)
        want = chain_head_reference(x, layers[:2], **bf)
        torch.cuda.synchronize()
        check(h2.dtype == torch.bfloat16, "chain_head bf16: h2 is not bf16")
        e_h = float((h2.float() - want).abs().max())
        differ = unexplained = 0
        for i in range(0, BATCH, 512):  # the check's fp32 temporaries
            d, u = chain_head_bf16_straddles(x[i:i + 512], layers[:2],
                                             h2[i:i + 512])
            differ, unexplained = differ + d, unexplained + u
        del want
        err["chain_head"] = max(err["chain_head"], e_h)
        res["straddles"] += differ
        res["h2_elements"] += h2.numel()
        print(f"[bf16 kernel] chain_head B={BATCH} n={n} cin={cin}: h2 bf16; "
              f"{differ} of {h2.numel()} elements differ from the plain "
              f"version (rounding-boundary straddles, max abs err "
              f"{e_h:.3e}), {unexplained} not explained by a straddle")
        check(unexplained == 0, f"chain_head bf16 disagrees with its plain "
                                f"version: B={BATCH} n={n} cin={cin}")
        for sym in ("max", "sum"):
            got = chain_tail(h2, layers[2], sym_op=sym, **bf)
            e_t, bad_t = _close(got, _chunked(torch, lambda v: (
                chain_tail_reference(v, layers[2], sym_op=sym, **bf)), h2,
                128), "chain_pool bf16 layer 3")
            got = chain_pool(x, layers, sym_op=sym, **bf)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"chain_pool bf16 {n}x{cin} {sym}: non-finite output")
            want = _chunked(torch, lambda v: chain_pool_reference(
                v, layers, sym_op=sym, **bf), x, 128)
            diff = (got.double() - want.double()).abs()
            scale = float(want.abs().max())
            e_c = float(diff.max()) / scale
            bad_c = int((diff > BF16_CHAIN_TOL * (scale + want.abs()))
                        .sum())
            err["chain_pool"] = max(err["chain_pool"], e_t)
            err["chain"] = max(err["chain"], e_c)
            print(f"[bf16 kernel] chain_pool B={BATCH} n={n} cin={cin} "
                  f"{sym}: layer 3 on the same bf16 h2 vs plain max_abs_err "
                  f"{e_t:.3e}, {bad_t} outside rtol 1e-4 / atol "
                  f"1e-4*max|ref|; whole chain vs plain max|err|/max|ref| "
                  f"{e_c:.3e}, {bad_c} outside rtol / atol 2^-8 x max|ref|")
            check(bad_t == 0 and bad_c == 0, f"chain_pool bf16 disagrees "
                                             f"with its plain version: "
                                             f"n={n} cin={cin} {sym}")
        t = {
            "chain": _events_ms(torch, lambda: chain_pool(x, layers, **bf), 5),
            "head": _events_ms(torch, lambda: chain_head(x, layers[:2], **bf),
                               5),
            "tail": _events_ms(torch, lambda: chain_tail(h2, layers[2], **bf),
                               5),
            "head_plain": _events_ms(torch, lambda: chain_head_reference(
                x, layers[:2], **bf), 2),
            "tail_plain": _events_ms(torch, lambda: _chunked(
                torch, lambda v: chain_tail_reference(v, layers[2], **bf), h2,
                128), 2),
        }
        times[(cin, n)] = t
        print(f"[bf16 kernel] B={BATCH} cin={cin} n={n} max: chain "
              f"{t['chain']:.4f} ms; chain_head {t['head']:.4f} ms vs plain "
              f"{t['head_plain']:.4f}; layer 3 {t['tail']:.4f} ms vs plain "
              f"{t['tail_plain']:.4f}")
        del x, h2
    tot = {k: sum(cnt * times[(cin, n)][k] for cin, n, cnt in CHAIN_SITES)
           for k in times[CHAIN_SITES[0][:2]]}
    res["head_cost"] = [sum(cnt * _head_cost(BATCH, n, cin, 2)[i]
                            for cin, n, cnt in CHAIN_SITES) for i in (0, 1)]
    res["tail_cost"] = [sum(cnt * _tail_cost(BATCH, n, h2_bytes=2)[i]
                            for cin, n, cnt in CHAIN_SITES) for i in (0, 1)]
    res.update(tot)
    b_head, _ = _bound(*res["head_cost"], PEAK_FLOPS_BF16)
    b_tail, _ = _bound(*res["tail_cost"], PEAK_FLOPS_BF16)
    print(f"[bf16 kernel] five chains of one B={BATCH} forward (max): "
          f"{tot['chain']:.4f} ms; chain_head {tot['head']:.4f} ms (bound "
          f"{b_head:.3f}), layer 3 {tot['tail']:.4f} ms (bound {b_tail:.3f}, "
          f"{b_tail / tot['tail']:.1%}); plain {tot['head_plain']:.4f} + "
          f"{tot['tail_plain']:.4f} ms; h2 straddles {res['straddles']} of "
          f"{res['h2_elements']}")

    gen = torch.Generator().manual_seed(SEED + 12)
    tails = {}
    for n, _ in TAIL_SITES:
        x = torch.relu(torch.randn((TRAIN_BATCH, n, 128), generator=gen)).to(
            device)
        w = (torch.randn((128, NET), generator=gen) / 128 ** 0.5).to(device)
        bias = (torch.randn((NET,), generator=gen) * 0.1).to(device)
        got = pooled_tail_reductions(x, w, bias, **bf)
        again = pooled_tail_reductions(x, w, bias, **bf)
        want = pooled_tail_reductions_reference(x, w, bias, **bf)
        torch.cuda.synchronize()
        for g, a in zip(got, again):
            check(torch.equal(g, a), f"pooled_tail bf16 n={n}: a rerun "
                                     f"differs")
        bad, e_p = 0, 0.0
        for g, r in zip(got, want):
            if g.dtype != torch.int32:
                e, nb = _close(g, r, "pooled_tail bf16")
                e_p, bad = max(e_p, e), bad + nb
        del want
        # the arg contract in the kernel's numerics: the bf16 product there
        c = torch.matmul(round_bf16(x), round_bf16(w)) + bias
        for v, a in ((got[0], got[1]), (got[2], got[3])):
            e, nb = _close(torch.gather(c, 1, a.long()[:, None, :])[:, 0], v,
                           "pooled_tail bf16 value at arg")
            e_p, bad = max(e_p, e), bad + nb
        del c
        err["pooled_tail"] = max(err["pooled_tail"], e_p)
        t_k = _events_ms(torch, lambda: pooled_tail_reductions(
            x, w, bias, **bf), 10)
        t_p = _events_ms(torch, lambda: pooled_tail_reductions_reference(
            x, w, bias, **bf), 5)
        tails[n] = (t_k, t_p)
        print(f"[bf16 kernel] pooled_tail B={TRAIN_BATCH} n={n} 128->{NET}: "
              f"max_abs_err {e_p:.3e} (rtol 1e-4, atol 1e-4*max|ref|, the "
              f"value at each arg included), {bad} outside, rerun "
              f"bit-identical; kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        check(bad == 0, f"pooled_tail bf16 disagrees with its plain version: "
                        f"n={n}")
        del x, got, again
    res["tail_ms"] = sum(cnt * tails[n][0] for n, cnt in TAIL_SITES)
    res["tail_plain_ms"] = sum(cnt * tails[n][1] for n, cnt in TAIL_SITES)
    res["pooled_tail_cost"] = [sum(cnt * _pooled_tail_cost(TRAIN_BATCH, n)[i]
                                   for n, cnt in TAIL_SITES) for i in (0, 1)]
    bound, _ = _bound(*res["pooled_tail_cost"], PEAK_FLOPS_BF16)
    _card_state("bf16 kernel")
    print(f"[bf16 kernel] five conv3 tails of one B={TRAIN_BATCH} train "
          f"forward: kernel {res['tail_ms']:.4f} ms, {bound / res['tail_ms']:.1%}"
          f" of the {bound:.3f} ms bound; plain {res['tail_plain_ms']:.4f} ms")
    return res


def _sweep(torch, np, fn, pts_t, n, queries, seed, device):
    """Signed distances of every query, in batches of BATCH (the last padded
    with its first query), drawn from a generator seeded ``seed``."""
    from points2surf_tpu_torch.infer.query import drain_batched_results

    gen = torch.Generator(device=device).manual_seed(seed)
    q_all = torch.from_numpy(queries).to(device)
    pending = []
    for s in range(0, len(queries), BATCH):
        q = q_all[s:s + BATCH]
        if len(q) < BATCH:
            q = torch.cat([q, q[:1].expand(BATCH - len(q), 3)])
        pending.append(fn(pts_t, q, n, gen))
    return drain_batched_results(pending, len(queries)), len(pending)


def _mode_agreement(np, d16, d32):
    """(share of queries with the same sign, max |d16 - d32|)."""
    return (float(np.mean(np.sign(d16) == np.sign(d32))),
            float(np.abs(d16 - d32).max()))


def phase_bf16_paths(torch, np, device, cfg, model, pts_pad, n, queries,
                     drv, tmp):
    """Phase 9, paths: the bf16 query and train step at full width, the
    train step against the CPU in bf16 mode, and phase 8's checkpoint
    reconstructed in both modes. Returns the bf16 launch counts by path."""
    from points2surf_tpu_torch.evalx import metrics
    from points2surf_tpu_torch.infer import evaluator, meshing
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.models.pointnet import _STNTrunk
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.ops.patches import draw_batch
    from points2surf_tpu_torch.train.trainer import make_train_step
    from points2surf_tpu_torch.utils import mesh_io

    kernels = (chain_head, chain_pool, pooled_tail_reductions)
    launched = {}

    def counts():
        return {f.__name__: (f.launches, f.launches_bf16) for f in kernels}
    pts_t = torch.from_numpy(pts_pad).to(device)
    fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=False)
    q_all = torch.from_numpy(queries).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)

    # the query at batch BATCH in bf16 mode, then the whole grid-256 sweep
    torch.cuda.synchronize()
    _zero_launches(*kernels)
    with _Bf16Mode():
        for i in range(BF16_WARMUP):
            fn(pts_t, q_all[i * BATCH:(i + 1) * BATCH], n, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(BF16_WARMUP, BF16_WARMUP + BF16_TIMED):
            out = fn(pts_t, q_all[i * BATCH:(i + 1) * BATCH], n, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(out.shape == (BATCH,) and bool(torch.isfinite(out).all()),
              "bf16 query output not finite or of the wrong shape")
        t0 = time.perf_counter()
        d16, n_sweep = _sweep(torch, np, fn, pts_t, n, queries, SEED + 11,
                              device)
        t_16 = time.perf_counter() - t0
    c = counts()
    n_batches = BF16_WARMUP + BF16_TIMED + n_sweep
    launched["query"] = c
    t0 = time.perf_counter()
    d32, _ = _sweep(torch, np, fn, pts_t, n, queries, SEED + 11, device)
    t_32 = time.perf_counter() - t0
    agree, delta = _mode_agreement(np, d16, d32)
    print(f"[bf16 query] {BATCH * BF16_TIMED / dt:.1f} queries/s at batch "
          f"{BATCH} with P2S_EVAL_CHAIN_PREC=default ({BF16_TIMED} timed "
          f"batches, {dt / BF16_TIMED * 1e3:.2f} ms/batch host clock); the "
          f"{len(queries)} grid-256 queries: bf16 sweep {t_16:.3f} s, fp32 "
          f"sweep {t_32:.3f} s ({n_sweep} batches each, the same draws): "
          f"same sign {agree:.6%}, max |diff| {delta:.3e}")
    print(f"[bf16 query] launches (fp32, bf16) over {n_batches} bf16 "
          f"batches: {c} (expected (0, {5 * n_batches}) for each chain "
          f"kernel)")
    check(bool(np.isfinite(d16).all()), "bf16 sweep: non-finite distances")
    for name in ("chain_head", "chain_pool"):
        check(c[name] == (0, 5 * n_batches),
              f"{name}: not 5 bf16 launches per bf16 forward: {c[name]}")

    # the train step at batch TRAIN_BATCH in bf16 mode
    steps = make_train_step(copy.deepcopy(model).to(device), OUTPUTS,
                            lr=0.01, momentum=0.9, patch_cfg=_train_cfg())
    gt = torch.from_numpy((np.random.RandomState(SEED).randn(TRAIN_BATCH)
                           * 0.05).astype(np.float32)).to(device)
    torch.cuda.synchronize()
    _zero_launches(*kernels)
    with _Bf16Mode():
        for i in range(BF16_WARMUP):
            steps.train_step_fused(
                pts_t, q_all[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], n, gt,
                gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(BF16_WARMUP, BF16_WARMUP + BF16_TIMED):
            losses, _ = steps.train_step_fused(
                pts_t, q_all[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], n, gt,
                gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    c = counts()
    launched["train"] = c
    n_steps = BF16_WARMUP + BF16_TIMED
    print(f"[bf16 train] {TRAIN_BATCH * BF16_TIMED / dt:.1f} train patches/s "
          f"at batch {TRAIN_BATCH} with P2S_PALLAS_TAIL_PREC=default "
          f"({dt / BF16_TIMED * 1e3:.2f} ms/step host clock); last losses "
          f"{losses.tolist()}; pooled_tail launches (fp32, bf16) "
          f"{c['pooled_tail_reductions']} over {n_steps} steps (expected "
          f"(0, {5 * n_steps}))")
    check(bool(torch.isfinite(losses).all()), "non-finite bf16 train loss")
    check(c["pooled_tail_reductions"] == (0, 5 * n_steps),
          "pooled_tail: not 5 bf16 launches per bf16 train step")
    del steps

    # one step at batch SLICE_TRAIN_BATCH, card against CPU, both in bf16
    # mode, on the card's batch, the transformers' last layers at zero
    b = SLICE_TRAIN_BATCH
    m0 = copy.deepcopy(model)
    with torch.no_grad():
        for mod in m0.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    draws = draw_batch(torch.Generator().manual_seed(SEED + 13), b,
                       pts_pad.shape[0], _train_cfg(), train=True)
    res, batch = [], None
    with _Bf16Mode():
        for dev in (device, torch.device("cpu")):
            m = copy.deepcopy(m0).to(dev)
            st = make_train_step(m, OUTPUTS, lr=0.01, momentum=0.9,
                                 patch_cfg=_train_cfg())
            if batch is None:  # on the card, then the same rows on the CPU
                batch = st.extract_train_batch(
                    pts_t, q_all[:b], n, gt[:b], type(draws)(
                        *(t.to(device) for t in vars(draws).values())))
            losses, _ = st.train_step({k: v.to(dev)
                                       for k, v in batch.items()})
            g = {k: p.grad.cpu() for k, p in m.named_parameters()}
            res.append((losses.cpu(), g))
    (l_g, g_g), (l_c, g_c) = res
    e_l = float(((l_g - l_c).abs() / l_c.abs()).max())
    g_max = max(float(v.abs().max()) for v in g_c.values())
    e_g = max(float((g_g[k] - v).abs().max()) for k, v in g_c.items()) / g_max
    print(f"[bf16 train] one step at batch {b}, card vs CPU in bf16 mode on "
          f"the card's batch: losses {l_g.tolist()} vs {l_c.tolist()}, max "
          f"rel err {e_l:.3e} (rtol 1e-3); gradients max|err| / max|g| "
          f"{e_g:.3e}")
    check(bool(torch.isfinite(l_g).all()) and e_l <= 1e-3,
          "the bf16 train step differs between card and CPU")

    # phase 8's trained checkpoint, reconstructed at grid DRIVER_GRID in
    # both modes with the same draws; meshes by full_run's settings
    eval_opt = argparse.Namespace(
        modeldir=drv["models"], modelpostfix="_model.npz",
        parampostfix="_params.json", eval_dtype="auto")
    m_rec, _ = evaluator.load_model_for_eval(eval_opt, "vanilla", device)
    fn_rec = make_sdf_query_fn(m_rec, drv["outputs"], drv["cfg"], False)
    rec_pts = torch.from_numpy(drv["test_pts_pad"]).to(device)
    rec_q = drv["rec_queries"]
    meshes, dists = {}, {}
    _zero_launches(*kernels)
    for mode in ("bf16", "fp32"):
        if mode == "bf16":
            with _Bf16Mode():
                dists[mode], n_rec = _sweep(torch, np, fn_rec, rec_pts,
                                            drv["test_n"], rec_q, SEED + 14,
                                            device)
            launched["reconstruction"] = counts()
        else:
            dists[mode], _ = _sweep(torch, np, fn_rec, rec_pts, drv["test_n"],
                                    rec_q, SEED + 14, device)
        ply = os.path.join(tmp, f"bf16_phase_{mode}.ply")
        ok = meshing.implicit_surface_to_mesh(
            dists[mode], rec_q, os.path.join(tmp, f"bf16_phase_{mode}.off"),
            ply, DRIVER_GRID, MESH_SIGMA, MESH_CERTAINTY, device=device)
        check(ok, f"no {mode} mesh was written")
        verts, faces = mesh_io.load_mesh(ply)
        faces = np.asarray(faces)
        check(len(faces) > 0 and _watertight(np, faces)
              and bool(np.isfinite(verts).all()),
              f"the {mode} mesh is empty, not finite or not watertight")
        meshes[mode] = (np.asarray(verts), faces)
    c = launched["reconstruction"]
    check(c["chain_head"] == (0, 5 * n_rec) and c["chain_pool"] == (0, 5 * n_rec),
          f"reconstruction in bf16 mode: launches {c}, expected (0, "
          f"{5 * n_rec}) each")
    agree, delta = _mode_agreement(np, dists["bf16"], dists["fp32"])
    samples = {k: metrics.sample_mesh_surface(v, f, 10000)
               for k, (v, f) in meshes.items()}
    chamfer = metrics.chamfer_distance(samples["bf16"], samples["fp32"])
    hd = metrics.hausdorff_distance(samples["bf16"], samples["fp32"])
    print(f"[bf16 mesh] phase 8's checkpoint, {len(rec_q)} grid-"
          f"{DRIVER_GRID} queries in each mode ({n_rec} batches of {BATCH}, "
          f"the same draws): same sign {agree:.6%}, max |diff| {delta:.3e}; "
          f"faces bf16 {len(meshes['bf16'][1])}, fp32 "
          f"{len(meshes['fp32'][1])}, both watertight; between the two "
          f"meshes (10,000 samples each) Chamfer {chamfer:.6f}, Hausdorff "
          f"{hd[2]:.6f} ({hd[0]:.6f} / {hd[1]:.6f})")
    return launched



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
    tail, mlp = phase_tail_kernels(torch, device)

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
    from points2surf_tpu_torch.ops.kernels.mlp_maxpool import mlp_maxpool

    # mlp_maxpool is counted over the two paths' runs (it has no caller)
    mlp_maxpool.launches = 0
    launches = phase_throughput(torch, device, cfg, model, pts_pad, n,
                                queries)
    mlp_launches = mlp_maxpool.launches
    phase_train_slice(torch, np, device, model, pts_pad, n, queries)
    mlp_maxpool.launches = 0
    tail_launches = phase_train_throughput(torch, np, device, model, pts_pad,
                                           n, queries)
    mlp_launches += mlp_maxpool.launches
    _, mesh_launches = phase_mesh(torch, np, device, cfg, model, pts,
                                  pts_pad, n)
    with tempfile.TemporaryDirectory() as tmp:
        mlp_maxpool.launches = 0
        drv = phase_driver(torch, np, device, tmp)
        mlp_launches += mlp_maxpool.launches
        t9 = time.perf_counter()
        from points2surf_tpu_torch.ops.kernels.chain_pool import (
            chain_head, chain_pool)
        from points2surf_tpu_torch.ops.kernels.pooled_tail import (
            pooled_tail_reductions)

        bf16_runs = {f.__name__: f.launches_bf16
                     for f in (chain_head, chain_pool, pooled_tail_reductions)}
        check(not any(bf16_runs.values()),
              f"a bf16 kernel launched in phases 1-8: {bf16_runs}")
        bf = phase_bf16_kernels(torch, device)
        bfl = phase_bf16_paths(torch, np, device, cfg, model, pts_pad, n,
                               queries, drv, tmp)
        print(f"[bf16] phase 9 took {time.perf_counter() - t9:.1f} s")
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {card}; "
          f"mlp_maxpool launches on the query, train and driver paths: "
          f"{mlp_launches} "
          "(no caller in either package)")
    q = kern[BATCH]
    b, n, cin, cout = MLP_SHAPES[1]
    mlp_flop = 2.0 * b * n * cin * cout
    mlp_bytes = 4.0 * (b * n * cin + cin * cout + cout + b * cout)
    # chain_head and chain_pool: the five call sites of one query forward at
    # batch BATCH; pooled_tail: the five conv3 tails of one train step;
    # mlp_maxpool: MLP_SHAPES[1]; the *_bf16 entries the same in the bf16
    # mode (phase 9), bound at the bf16 peak. No single PyTorch call
    # computes any of these functions, so library_ms is null. launches sums
    # the paths (query phase 4, train phase 6, mesh phase 7, driver phase 8;
    # the bf16 query, train step and reconstruction of phase 9; each counted
    # from 0 just before it), launches_by_path splits them.
    dl = drv["launches"]
    by_path = {
        "chain_head": {"query": launches["chain_head"],
                       "mesh": mesh_launches["chain_head"],
                       "driver": dl["chain_head"]},
        "chain_pool": {"query": launches["chain_pool"],
                       "mesh": mesh_launches["chain_pool"],
                       "driver": dl["chain_pool"]},
        "pooled_tail": {"train": tail_launches, "driver": dl["pooled_tail"]},
        "mlp_maxpool": {"all": mlp_launches},
        "chain_head_bf16": {
            "query": bfl["query"]["chain_head"][1],
            "reconstruction": bfl["reconstruction"]["chain_head"][1]},
        "chain_pool_bf16": {
            "query": bfl["query"]["chain_pool"][1],
            "reconstruction": bfl["reconstruction"]["chain_pool"][1]},
        "pooled_tail_bf16": {
            "train": bfl["train"]["pooled_tail_reductions"][1]},
    }
    entries = (
        ("chain_head", "chain_head.cu", "chain_kernel.py:187",
         max(kern["err"]["chain_head"], drv["err"]["chain_head"]), q["head"],
         q["head_plain"], *q["head_cost"]),
        ("chain_pool", "chain_pool.cu", "chain_kernel.py:187",
         max(kern["err"]["chain_pool"], drv["err"]["chain_pool"]), q["tail"],
         q["tail_plain"], *q["tail_cost"]),
        ("pooled_tail", "pooled_tail.cu", "train_tail.py:138",
         max(tail["max_abs_err"], drv["err"]["pooled_tail"]), tail["ms"],
         tail["plain_ms"], *tail["cost"]),
        ("mlp_maxpool", "mlp_maxpool.cu", "encoder_tail.py:52",
         mlp["max_abs_err"], mlp["ms"], mlp["plain_ms"], mlp_flop,
         mlp_bytes),
        ("chain_head_bf16", "chain_head.cu", "chain_kernel.py:187",
         bf["err"]["chain_head"], bf["head"], bf["head_plain"],
         *bf["head_cost"]),
        ("chain_pool_bf16", "chain_pool.cu", "chain_kernel.py:187",
         bf["err"]["chain_pool"], bf["tail"], bf["tail_plain"],
         *bf["tail_cost"]),
        ("pooled_tail_bf16", "pooled_tail.cu", "train_tail.py:138",
         bf["err"]["pooled_tail"], bf["tail_ms"], bf["tail_plain_ms"],
         *bf["pooled_tail_cost"]),
    )
    kernels = []
    for name, src, tpu, err, ms, plain_ms, flop, nbytes in entries:
        bound_ms, bound_by = _bound(
            flop, nbytes,
            PEAK_FLOPS_BF16 if name.endswith("_bf16") else PEAK_FLOPS)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"points2surf_tpu_torch/csrc/{src}",
            "replaces": f"points2surf_tpu/ops/pallas/{tpu}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
