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
   faces, Chamfer and Hausdorff distance between the two meshes);
10. the options of the landed slices: each kernel against its plain
   version at large_kNN's and small_kNN's patch sizes (n = 1200, 75);
   ball mode (r = 0.05 and 0.2) on the bench model: the query slice on the
   card against the CPU with the same draws, queries/s at batch 4096 with
   the share of tiles that certify and the chain launches per batch, the
   chain kernels at a ball batch's call sites and ``pooled_tail`` at a
   ball-mode train step's tails (duplicate rows: first-index args,
   bit-identical reruns); the uniform sub-sample in train_p2s_uniform.sh's
   and train_p2s_max.sh's models (one step at batch 64 against the CPU in
   float64, patches/s at batch 1000, one ``pooled_tail`` launch per trunk
   and encoder per step); bf16 activations (queries/s at batch 4096 with
   128 of the batch's rows against the CPU, patches/s at batch 1000 and a
   step at batch 64 against the CPU, no kernel launched); ``full_train``
   at the reference's defaults (ball mode) for one epoch and ``full_eval``
   with its reconstruction at grid 64;
11. dataset generation (``ops/raycast.py``, ``ops/meshdist.py``,
   ``datagen/``, ``cli/make_dataset.py``): ``signed_distance`` on
   abc_minimal's 2,000 query points of each mesh against the reference's
   trimesh ground truth (``05_query_dist``) and against the CPU,
   ``closest_point_on_mesh`` card against CPU; every full-resolution scan
   of the largest ABC mesh (16,158 faces) on the card, ms per scan and
   peak memory, its first scan held ray for ray against the CPU; the
   ``make_dataset`` CLI on four procedural meshes at abc_minimal's
   ``settings.ini``, seconds by stage and by mesh, every stage directory
   and split file, one mesh's distances against the CPU and
   ``reconstruct_gt`` of it at grid 128 (watertight, Hausdorff to the
   input within 2 voxels); one ``full_train`` epoch on the generated
   dataset (``pooled_tail`` 5 per step); each device op at these shapes:
   ms per call, peak memory, the operations and bytes of its eager ops,
   and its bound;
12. data parallelism (``parallel/``): two processes on the one card joined
   by gloo (NCCL takes one rank per card), each with half of phase 6's
   batch (zero-started transformer last layers), three fused steps, each
   against the one-process step on the whole batch from the same state
   (losses rtol 1e-4, the first
   step's gradients within 1e-3 * max|g| of the model), the parameters and
   running statistics bit-identical on both ranks, five ``pooled_tail``
   launches per step on each rank and the arg indices that differ from
   the one-process step; the one-process steps launch no collective;
   each rank's ms per step, patches/s and the all-reduces' share of a
   step; the evaluator on phase 8's checkpoint over abc_minimal's three
   shapes (first 150 queries each), round-robin over the two ranks: every
   shape written once, each rank's files against the CPU run of the same
   share; each kernel against its plain version at the ranks' call sites.

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
# phase 10: the options of the landed slices. Ball mode at two radii on the
# bench model (the tile depth then is 8,192 and 18,432 on the padded cloud)
BALL_RADII = (0.05, 0.2)
OPT_WARMUP = 2
OPT_TIMED = 5
# the patch sizes of experiments/train_p2s_{large,small}_kNN.sh: new chain
# and tail call sites
KNN_SITES = (1200, 75)
# experiments/train_p2s_uniform.sh and _max.sh: the uniform sub-sample with
# non-shared transformers, and the same without the point STN
UNIFORM_CONFIGS = {"uniform": {"shared_transformation": False},
                   "max": {"shared_transformation": False,
                           "use_point_stn": False}}
# bf16 activations, card against CPU: the CPU's bf16 matmuls are slow, so
# the query's first BF16_ACT_ROWS rows (eval rows are independent) and a
# train step at SLICE_TRAIN_BATCH
BF16_ACT_ROWS = 128
U_BF16 = 2.0 ** -8  # bf16 unit round-off
# the CLIs at the reference's defaults (ball mode, r = 0.05) but one epoch
# and batch CLI_BATCH (the default 2 would take 1,000 steps), then full_eval
# with the reconstruction at grid CLI_GRID
CLI_BATCH = 50
CLI_GRID = 64
# the experiments' outputs: the reference's default list adds 'imp_surf', a
# third prediction, and compute_loss then holds all B * 3 predictions
# against B targets and fails, in the JAX package too
CLI_OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign", "patch_pts_ids",
               "p_index")
# phase 11: dataset generation. The device ops at the largest bundled ABC
# mesh (16,158 faces): its full-resolution scans and abc_minimal's 2,000
# query points; the make_dataset CLI on DATAGEN_MESHES procedural meshes at
# abc_minimal's settings; reconstruct_gt at grid DATAGEN_GRID on one of
# them; one training epoch on the generated dataset at the reference's
# defaults (ball mode) with batch DRIVER_BATCH and DATAGEN_PATCHES patches
# per shape
DATAGEN_BIG = "00011084_fddd53ce45f640f3ab922328_trimesh_019.ply"
DATAGEN_MESHES = 4
DATAGEN_GRID = 128
DATAGEN_PATCHES = 500
DATAGEN_TIMED = 5
# phase 12: data parallelism. PARALLEL_RANKS gloo ranks share the card, each
# with its rows of phase 6's batch of TRAIN_BATCH, PARALLEL_STEPS fused
# steps against one process on the whole batch, then PARALLEL_TIMED timed
# steps twice (as they run, and with each all-reduce timed); every rank
# stops after PARALLEL_TIMEOUT seconds
PARALLEL_RANKS = 2
PARALLEL_STEPS = 3
PARALLEL_TIMED = 5
PARALLEL_TIMEOUT = 600
DATAGEN_STAGES = ("00_base_meshes", "01_base_meshes_ply",
                  "02_meshes_cleaned", "03_meshes", "04_pts", "04_pts_vis",
                  "04_pts_locations", "04_pts_rotations", "04_hits_per_scan",
                  "05_query_pts", "05_query_dist")
# the device ops are elementwise fp32 outside the tensor cores: 67 TFLOP/s
# (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12
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


def _bench_model(torch, device, **variant):
    """bench.py's model (or the ``variant`` flags of another experiment)
    with seeded default init and randomized BN stats."""
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.models.pointnet import BN

    torch.manual_seed(SEED)
    flags = dict(use_point_stn=True, use_feat_stn=True,
                 shared_transformation=True)
    flags.update(variant)
    model = PointsToSurfModel(net_size_max=NET, output_dim=2, **flags)
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


def phase_train_slice(torch, np, device, model, pts_pad, n, queries,
                      cfg=None, tag="train-slice"):
    """One fused train step on the GPU against the same step on the CPU in
    float64, from the same weights, momentum buffers, draws and rotations
    (extraction by ``cfg``, ``_train_cfg()`` unless given).

    The CPU runs the same code in float64 (the plain versions take any
    float type), which makes it the exact reference: in float32 the CPU
    step is the less accurate one on this path (on an H100 host, in the
    global encoder's first layers: GPU vs CPU float32 5.8e-3 of max|g|,
    GPU vs CPU float64 1.7e-5, CPU float32 vs float64 5.8e-3).

    Two implementations can also order near-ties differently, and the step
    has two places where order is data: the patch and sub-sample rows
    (neighbours at nearly equal distances), and the max pools' arg decisions
    (a flipped arg routes one row's gradient elsewhere). So the extractions
    are compared as point sets, and the CPU steps (float64, and float32 for
    the CPU's own float32 error, a floor for the card's gradients) then
    train on the GPU's batch; the GPU step records the kernel's arg indices, and the CPU step's
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
    from points2surf_tpu_torch.ops.patches import draw_batch
    from points2surf_tpu_torch.train.trainer import make_train_step

    cfg = cfg or _train_cfg()
    b = SLICE_TRAIN_BATCH
    rs = np.random.RandomState(SEED + 3)
    q = torch.from_numpy(queries[:b])
    gt = torch.from_numpy((rs.randn(b) * 0.05).astype(np.float32))
    draws = draw_batch(torch.Generator().manual_seed(SEED + 3), b,
                       pts_pad.shape[0], cfg, train=True, n_valid=n)
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
    recorded, queue = [], []
    stats = {"args": 0, "own_arg_differs": 0, "bad_args": 0}
    counting = [True]

    def record(x, w, bias):
        out = real(x, w, bias)
        recorded.append((out[1].cpu(), out[3].cpu()))
        return out

    def replay(x, w, bias):
        cmax, amax, cmin, amin, rsum, rsq = (
            pooled_tail_reductions_reference(x, w, bias))
        gmax, gmin = queue.pop(0)
        c = torch.matmul(x, w) + bias
        tol = 1e-4 * float(c.abs().max())
        pooled = []
        for own, val, g in ((amax, cmax, gmax), (amin, cmin, gmin)):
            at = torch.gather(c, 1, g.long()[:, None, :])[:, 0]
            if counting[0]:
                stats["args"] += g.numel()
                stats["own_arg_differs"] += int((own != g).sum())
                stats["bad_args"] += int(((at - val).abs()
                                          > tol + 1e-4 * val.abs()).sum())
            pooled.append(at)
        return pooled[0], gmax, pooled[1], gmin, rsum, rsq

    res, batches = [], []
    f64 = torch.float64
    cpu = torch.device("cpu")
    # the card in float32, then the CPU in float64 (the reference) and in
    # float32 (the CPU's own float32 error, a floor for the card's)
    for dev, dtype, hook in ((device, torch.float32, record),
                             (cpu, f64, replay), (cpu, torch.float32, replay)):
        queue[:] = recorded
        counting[0] = dtype == f64
        m = copy.deepcopy(model).to(device=dev, dtype=dtype)
        steps = make_train_step(m, OUTPUTS, lr=0.01, momentum=0.9,
                                patch_cfg=cfg)
        steps.load_sgd_state(momentum, None)
        d = draws.to(dev, dtype)
        pn.pooled_tail_reductions = hook
        try:
            t0 = time.perf_counter()
            batch = steps.extract_train_batch(
                torch.from_numpy(pts_pad).to(dev, dtype), q.to(dev, dtype),
                n, gt.to(dev, dtype), d)
            batches.append({k: v.cpu() for k, v in batch.items()})
            if dev == cpu:  # the GPU's rows, in the GPU's order
                batch = {k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in batches[0].items()}
            losses, metrics = steps.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            pn.pooled_tail_reductions = real
        print(f"[{tag}] {dev.type} {str(dtype)[6:]} step at batch {b}: "
              f"{dt:.2f} s")
        named = dict(m.named_parameters())
        res.append({
            "losses": losses.cpu().to(f64),
            "metrics": {k: v.cpu().to(f64) for k, v in metrics.items()},
            "grads": {k: named[k].grad.cpu().to(f64) for k in names},
            "state": {k: v.cpu().to(f64) for k, v in m.state_dict().items()},
        })
        del m, steps
        check(dev != cpu or not queue,
              "the CPU step ran fewer pooled tails than the GPU")
    for k in ("patch_pts_ps", "pts_sub_sample_ms"):
        e = float((_sorted_points(torch, batches[0][k].to(f64))
                   - _sorted_points(torch, batches[1][k])).abs().max())
        print(f"[{tag}] extraction {k} {tuple(batches[1][k].shape)} "
              f"GPU vs CPU as point sets: max_abs_err {e:.3e} (atol 1e-5)")
        check(e <= 1e-5, f"train extraction {k} differs between GPU and CPU")
    for k in ("patch_radius_ms", "imp_surf_query_point_ms"):
        e = float((batches[0][k].to(f64) - batches[1][k]).abs().max())
        print(f"[{tag}] extraction {k} GPU vs CPU max_abs_err {e:.3e}")
        check(e <= 1e-5, f"train extraction {k} differs between GPU and CPU")
    g, c, c32 = res
    print(f"[{tag}] arg decisions {stats['args']}: the GPU's index is "
          f"not the CPU's own first arg in {stats['own_arg_differs']} "
          f"(near-ties), and not an arg of the CPU values in "
          f"{stats['bad_args']}")
    check(stats["bad_args"] == 0, "a GPU arg index is not an arg on the CPU")
    check(bool(torch.isfinite(g["losses"]).all()), "non-finite train loss")
    err = float(((g["losses"] - c["losses"]).abs()
                 / c["losses"].abs()).max())
    print(f"[{tag}] losses GPU {g['losses'].tolist()} CPU "
          f"{c['losses'].tolist()}: max rel err {err:.3e} (rtol 1e-4)")
    check(err <= 1e-4, "train losses differ between GPU and CPU")
    for k, v in c["metrics"].items():
        w = g["metrics"][k]
        same = bool(torch.isclose(w, v, rtol=1e-4, atol=0.0, equal_nan=True))
        print(f"[{tag}] metric {k}: GPU {w.item():.6f} CPU "
              f"{v.item():.6f}")
        check(same, f"train metric {k} differs between GPU and CPU")
    g_max = max(float(t.abs().max()) for t in c["grads"].values())
    worst, bad_tensors, floored = (0.0, ""), [], []
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
            # a float32 step is held no closer to float64 than the CPU's
            # own float32 step comes (a ReLU input within rounding of 0)
            own = float((c32["grads"][k] - cg).abs().max())
            (floored if float(e.max()) <= 2 * own else bad_tensors).append(
                (k, float(e.max()) / scale, own / scale))
    print(f"[{tag}] gradients of {len(names)} tensors: worst max|err| "
          f"/ max|g| {worst[0]:.3e} ({worst[1]}); outside rtol 1e-3 / atol "
          f"1e-3*max|g| but within twice the CPU float32 step's own error "
          f"(tensor, card err / max|g|, CPU float32 err / max|g|): "
          f"{floored[:5]}; outside both {bad_tensors[:5]}")
    check(not bad_tensors, "gradients differ between GPU and CPU")
    bad_state, floored, worst = [], [], 0.0
    for k, v in c["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        e = (g["state"][k] - v).abs()
        worst = max(worst, float(e.max()))
        if bool((e > 1e-6 + 1e-4 * v.abs()).any()):
            own = float((c32["state"][k] - v).abs().max())
            (floored if float(e.max()) <= 2 * own else bad_state).append(
                (k, float(e.max()), own))
    print(f"[{tag}] updated parameters and running statistics: max abs "
          f"err {worst:.3e}; outside rtol 1e-4 / atol 1e-6 but within twice "
          f"the CPU float32 step's own error (tensor, card err, CPU float32 "
          f"err): {floored[:5]}; outside both {bad_state[:5]}")
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

            def draw(g, b, n, cfg, small_cloud=False, train=False,
                     n_valid=None, dev=dev, gen=gen):
                return real_draw(gen, b, n, cfg, small_cloud, train,
                                 n_valid).to(dev)

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
                    pts_t, q_all[:b], n, gt[:b], draws.to(device))
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



def _first_index_check(torch, recorded, tag):
    """pooled_tail at the train tails ``recorded`` from a ball-mode step:
    each call rerun bit-identical, and where x holds duplicate rows (the pad
    slots on the query point) every max and min arg is the first of its
    duplicates, as JAX's argmax takes it. Returns the duplicate-row share."""
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)

    dups = rows = 0
    for (shape, cout), (x, w, b) in sorted(recorded.items()):
        got = pooled_tail_reductions(x, w, b)
        again = pooled_tail_reductions(x, w, b)
        torch.cuda.synchronize()
        for g, a in zip(got, again):
            check(torch.equal(g, a), f"pooled_tail {shape}: a rerun differs")
        first = torch.empty(x.shape[:2], dtype=torch.int64, device=x.device)
        ar = torch.arange(x.shape[1], device=x.device)
        for i in range(x.shape[0]):
            _, inv = torch.unique(x[i], dim=0, return_inverse=True)
            low = torch.full((int(inv.max()) + 1,), x.shape[1],
                             dtype=torch.int64, device=x.device)
            first[i] = low.scatter_reduce(0, inv, ar, "amin")[inv]
        dups += int((first != ar).sum())
        rows += x.shape[0] * x.shape[1]
        for a in (got[1], got[3]):
            a = a.long()
            check(bool((torch.gather(first, 1, a) == a).all()),
                  f"pooled_tail {shape}: an arg is not the first of its "
                  f"duplicate rows")
        print(f"[{tag}] pooled_tail B={shape[0]} n={shape[1]} 128->{cout}: "
              f"{int((first != ar).sum())} of {x.shape[0] * x.shape[1]} rows "
              f"duplicate an earlier one; every arg the first of its "
              f"duplicates; rerun bit-identical")
    return dups / max(rows, 1)


def phase_option_kernels(torch, device):
    """Phase 10, kernels at the new call sites: chain_head and layer 3 at
    the query batch with large_kNN's and small_kNN's patch sizes (n = 1200,
    75; Cin 3 and 64; both pools), pooled_tail at the train batch with them
    (the value at each arg is the pool; reruns bit-identical)."""
    import types

    gen = torch.Generator().manual_seed(SEED + 20)
    dgen = torch.Generator(device=device).manual_seed(SEED + 21)
    sites = types.SimpleNamespace(chain={}, tail={})
    for n in KNN_SITES:
        for cin in (3, 64):
            x = torch.randn((BATCH, n, cin), generator=dgen, device=device)
            layers = _random_chain(torch, gen, cin, device)
            for sym in ("max", "sum"):
                sites.chain[((BATCH, n, cin), sym, False, NET)] = (x, layers)
        x = torch.relu(torch.randn((TRAIN_BATCH, n, 128), generator=gen))
        w = torch.randn((128, NET), generator=gen) / 128 ** 0.5
        b = torch.randn((NET,), generator=gen) * 0.1
        sites.tail[((TRAIN_BATCH, n, 128), NET)] = tuple(
            t.to(device) for t in (x, w, b))
    err = _driver_sites_check(torch, sites, "options kernel")
    _first_index_check(torch, sites.tail, "options kernel")
    return err


def phase_ball(torch, np, device, model, pts_pad, n, queries):
    """Phase 10, ball mode on the bench model at each of BALL_RADII: the
    query slice on the card against the CPU with the same draws (ball
    priorities included: the same patches in most rows, all in their balls,
    and the model on the card's batch against the CPU); queries/s at batch BATCH with the share of tiles
    that certify and the chain launches per batch; the chain kernels at the
    call sites of a ball-mode batch, and pooled_tail at the tails of a
    ball-mode train step (duplicate rows: first-index args)."""
    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.ops import patches
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.train.trainer import make_train_step

    cpu = torch.device("cpu")
    model_cpu = copy.deepcopy(model).to(cpu)
    pts_t = torch.from_numpy(pts_pad).to(device)
    q_all = torch.from_numpy(queries).to(device)
    res = {"err": {"chain_head": 0.0, "chain_pool": 0.0, "pooled_tail": 0.0},
           "launches": {"chain_head": 0, "chain_pool": 0}, "qps": {}}

    def batch_queries(i, rows=BATCH):
        s = (i * rows) % (len(queries) - rows)
        return q_all[s:s + rows]

    for r in BALL_RADII:
        cfg = patches.PatchConfig(points_per_patch=300, patch_radius=r,
                                  sub_sample_size=1000,
                                  subsample_candidates=4)
        depth = patches._ball_tile_candidates(cfg, len(pts_pad))
        q = torch.from_numpy(queries[:256])
        out = []
        for dev in (device, cpu):
            draws = patches.draw_batch(
                torch.Generator().manual_seed(SEED + 30), len(q),
                len(pts_pad), cfg, n_valid=n).to(dev)
            batch = patches.extract_patches(
                torch.from_numpy(pts_pad).to(dev), q.to(dev), n, draws,
                cfg=cfg)
            out.append({k: v.cpu() for k, v in batch.items()})
        g, c = out
        e = float((_sorted_points(torch, g["pts_sub_sample_ms"])
                   - _sorted_points(torch, c["pts_sub_sample_ms"])).abs().max())
        check(e <= 1e-5, f"ball r={r}: the sub-sample differs between card "
                         f"and CPU ({e:.3e})")
        check(bool((g["patch_radius_ms"] == r).all()),
              f"ball r={r}: the radius is not the fixed radius")
        # selection: the same priorities go to the same candidate slots, so
        # rows agree unless two candidates' centroid distances round apart
        # on the two devices and swap slots (and priorities); every point
        # lies in its ball either way
        slots = {}
        for tag, b in (("card", g), ("cpu", c)):
            norm = torch.linalg.vector_norm(b["patch_pts_ps"], dim=-1)
            check(float(norm.max()) <= 1.0 + 1e-5,
                  f"ball r={r}: a {tag} patch point lies outside its ball")
            slots[tag] = norm > 0
        shared = []
        for i in range(len(q)):
            a = set(g["patch_pts_ids"][i][slots["card"][i]].tolist())
            b = set(c["patch_pts_ids"][i][slots["cpu"][i]].tolist())
            shared.append(len(a & b) / max(len(a), len(b)) if a or b
                          else 1.0)
        same = sum(v == 1.0 for v in shared)
        overlap = sum(shared) / len(shared)
        pad = float((~slots["card"]).float().mean())
        # the model on the card's batch, card against CPU
        with torch.inference_mode():
            pg = model({k: v.to(device) for k, v in g.items()}).cpu()
            pc = model_cpu(g)
        err = (pg - pc).abs()
        bad = int((err > 1e-4 + 1e-3 * pc.abs()).sum())
        confident = pc[:, 1].abs() > 1e-3
        flips = int(((torch.sign(pg[:, 1]) != torch.sign(pc[:, 1]))
                     & confident).sum())
        print(f"[ball r={r}] tile depth {depth}; the query slice (256 grid "
              f"queries), card vs CPU with the same draws: the sub-sample "
              f"equal as point sets (atol 1e-5); the same patch in {same} of "
              f"{len(q)} rows, {overlap:.4%} of the patch points shared "
              f"(held at 99%; the least in a row {min(shared):.2%}, held at "
              f"90%), every point in its ball; "
              f"{pad:.1%} of the card's patch slots padded; the model on the "
              f"card's batch: raw output max_abs_err {float(err.max()):.3e}, "
              f"{bad} outside rtol 1e-3 / atol 1e-4, {flips} sign flips")
        check(overlap >= 0.99 and min(shared) >= 0.9,
              f"ball r={r}: the card's patches differ from the CPU's")
        check(bad == 0 and flips == 0, f"ball r={r}: the query slice differs "
                                       f"between card and CPU")

        fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=True)
        gen = torch.Generator(device=device).manual_seed(SEED)
        certs = []
        real = patches._tile_select

        def recording(*args, **kw):
            got = real(*args, **kw)
            certs.append(got[2])
            return got

        patches._tile_select = recording
        try:
            with _Recorder(pn) as rec:  # the call sites of one batch
                fn(pts_t, batch_queries(0), n, gen)
            torch.cuda.synchronize()
            certs.clear()
            _zero_launches(chain_head, chain_pool)
            for i in range(1, 1 + OPT_WARMUP):
                fn(pts_t, batch_queries(i), n, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(1 + OPT_WARMUP, 1 + OPT_WARMUP + OPT_TIMED):
                dist = fn(pts_t, batch_queries(i), n, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            patches._tile_select = real
        n_batches = OPT_WARMUP + OPT_TIMED
        cert = torch.cat(certs).float()
        launched = {f.__name__: f.launches for f in (chain_head, chain_pool)}
        qps = BATCH * OPT_TIMED / dt
        res["qps"][r] = qps
        for k, v in launched.items():
            res["launches"][k] += v
        print(f"[ball r={r}] {qps:.1f} queries/s at batch {BATCH} "
              f"({OPT_TIMED} timed batches, {dt / OPT_TIMED * 1e3:.2f} "
              f"ms/batch host clock); tiles certified {float(cert.mean()):.1%}"
              f" ({int(cert.sum())} of {cert.numel()}), batches falling back "
              f"{sum(not bool(t.all()) for t in certs)} of {n_batches}; "
              f"launches per batch: chain_head "
              f"{launched['chain_head'] / n_batches}, chain_pool "
              f"{launched['chain_pool'] / n_batches}")
        check(dist.shape == (BATCH,) and bool(torch.isfinite(dist).all()),
              f"ball r={r}: distances not finite or of the wrong shape")
        for k, v in launched.items():
            check(v == 5 * n_batches, f"ball r={r}: {k} launched {v} times "
                                      f"over {n_batches} batches")
        e = _driver_sites_check(torch, rec, f"ball r={r}")
        for k in ("chain_head", "chain_pool"):
            res["err"][k] = max(res["err"][k], e[k])

    # a ball-mode train step at TRAIN_BATCH: its tails see the pad slots'
    # duplicate rows
    cfg = patches.PatchConfig(points_per_patch=300, patch_radius=0.05,
                              sub_sample_size=1000)
    steps = make_train_step(copy.deepcopy(model), OUTPUTS, lr=0.01,
                            momentum=0.9, patch_cfg=cfg, fixed_radius=True)
    gt = torch.from_numpy((np.random.RandomState(SEED).randn(TRAIN_BATCH)
                           * 0.05).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    with _Recorder(pn) as rec:
        losses, _ = steps.train_step_fused(
            pts_t, batch_queries(3, TRAIN_BATCH), n, gt, gen)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses).all()), "non-finite ball train loss")
    e = _driver_sites_check(torch, rec, "ball train")
    res["err"]["pooled_tail"] = max(res["err"]["pooled_tail"],
                                    e["pooled_tail"])
    res["dup_share"] = _first_index_check(torch, rec.tail, "ball train")
    del steps
    return res


def _train_rate(torch, np, device, model, cfg, n, pts_pad, queries, tag,
                fixed_radius=False):
    """Train patches/s at TRAIN_BATCH (OPT_TIMED fused steps after
    OPT_WARMUP) and the kernels' launches per step (both modes)."""
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.train.trainer import make_train_step

    steps = make_train_step(copy.deepcopy(model).to(device), OUTPUTS,
                            lr=0.01, momentum=0.9, patch_cfg=cfg,
                            fixed_radius=fixed_radius)
    pts_t = torch.from_numpy(pts_pad).to(device)
    q_all = torch.from_numpy(queries).to(device)
    gt = torch.from_numpy((np.random.RandomState(SEED).randn(TRAIN_BATCH)
                           * 0.05).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def step(i):
        s = (i * TRAIN_BATCH) % (len(queries) - TRAIN_BATCH)
        return steps.train_step_fused(pts_t, q_all[s:s + TRAIN_BATCH], n, gt,
                                      gen)

    kernels = (chain_head, chain_pool, pooled_tail_reductions)
    torch.cuda.synchronize()
    _zero_launches(*kernels)
    for i in range(OPT_WARMUP):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OPT_WARMUP, OPT_WARMUP + OPT_TIMED):
        losses, _ = step(i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_steps = OPT_WARMUP + OPT_TIMED
    launched = {f.__name__: (f.launches, f.launches_bf16) for f in kernels}
    pps = TRAIN_BATCH * OPT_TIMED / dt
    print(f"[{tag}] {pps:.1f} train patches/s at batch {TRAIN_BATCH} "
          f"({OPT_TIMED} timed steps, {dt / OPT_TIMED * 1e3:.2f} ms/step host "
          f"clock); last losses {losses.tolist()}; launches (fp32, bf16) over "
          f"{n_steps} steps: {launched}")
    check(bool(torch.isfinite(losses).all()), f"{tag}: non-finite loss")
    return pps, launched, n_steps


def phase_uniform(torch, np, device, pts_pad, n, queries):
    """Phase 10, the uniform with-replacement sub-sample in
    train_p2s_uniform.sh's and train_p2s_max.sh's model configs: one step
    at batch 64 on the card against the CPU in float64 (phase 5's check),
    then patches/s at TRAIN_BATCH with a pooled_tail launch per trunk and
    encoder per step (5; 4 without the point STN)."""
    from points2surf_tpu_torch.ops.patches import PatchConfig

    cfg = PatchConfig(points_per_patch=300, patch_radius=0.0,
                      sub_sample_size=1000, uniform_subsample=True)
    res = {"pps": {}, "launches": 0}
    for name, variant in UNIFORM_CONFIGS.items():
        model = _bench_model(torch, device, **variant)
        phase_train_slice(torch, np, device, model, pts_pad, n, queries,
                          cfg=cfg, tag=f"uniform {name} slice")
        pps, launched, n_steps = _train_rate(
            torch, np, device, model, cfg, n, pts_pad, queries,
            f"uniform {name}")
        res["pps"][name] = pps
        fp32, bf16 = launched["pooled_tail_reductions"]
        tails = 5 if variant.get("use_point_stn", True) else 4
        check(fp32 == tails * n_steps and bf16 == 0,
              f"uniform {name}: pooled_tail launched {launched}, expected "
              f"{tails} per step")
        res["launches"] += fp32
        del model
    return res


def phase_bf16_act(torch, np, device, model, pts_pad, n, queries):
    """Phase 10, bf16 activations (``--train_dtype`` / ``--eval_dtype
    bfloat16``; not the operand modes of phase 9): the query at batch BATCH
    (queries/s) with its first BF16_ACT_ROWS rows on the CPU, the train step
    at TRAIN_BATCH (patches/s) and one step at SLICE_TRAIN_BATCH on the
    card's batch against the CPU; no kernel launches in any of them."""
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.models.pointnet import _STNTrunk, set_act_dtype
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.ops.patches import PatchConfig, extract_patches
    from points2surf_tpu_torch.train.trainer import make_train_step

    kernels = (chain_head, chain_pool, pooled_tail_reductions)
    bf16 = torch.bfloat16
    cpu = torch.device("cpu")
    m16 = copy.deepcopy(model)
    set_act_dtype(m16, bf16)
    cfg = PatchConfig(points_per_patch=300, patch_radius=0.0,
                      sub_sample_size=1000, subsample_candidates=4)
    pts_t = torch.from_numpy(pts_pad).to(device)
    q_all = torch.from_numpy(queries).to(device)
    fn = make_sdf_query_fn(m16, OUTPUTS, cfg, fixed_radius=False)
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    torch.cuda.synchronize()
    _zero_launches(*kernels)
    for i in range(OPT_WARMUP):
        fn(pts_t, q_all[i * BATCH:(i + 1) * BATCH], n, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OPT_WARMUP, OPT_WARMUP + OPT_TIMED):
        dist = fn(pts_t, q_all[i * BATCH:(i + 1) * BATCH], n, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    qps = BATCH * OPT_TIMED / dt
    with torch.inference_mode():
        batch = extract_patches(pts_t, q_all[:BATCH], n, gen, cfg=cfg)
        pred = m16(batch)
    torch.cuda.synchronize()
    launched = {f.__name__: (f.launches, f.launches_bf16) for f in kernels}
    check(dist.dtype == torch.float32 and bool(torch.isfinite(dist).all()),
          "bf16 activations: query distances not finite float32")
    m16_cpu = copy.deepcopy(m16).to(cpu)
    t0 = time.perf_counter()
    with torch.inference_mode():
        pc = m16_cpu({k: v[:BF16_ACT_ROWS].to(cpu) for k, v in batch.items()})
    t_cpu = time.perf_counter() - t0
    pg = pred[:BF16_ACT_ROWS].float().cpu()
    pc = pc.float()
    scale = float(pc.abs().max())
    err = float((pg - pc).abs().max())
    sure = pc[:, 1].abs() > 32 * U_BF16 * scale
    flips = int(((torch.sign(pg[:, 1]) != torch.sign(pc[:, 1])) & sure).sum())
    print(f"[bf16 act query] {qps:.1f} queries/s at batch {BATCH} "
          f"({OPT_TIMED} timed batches, {dt / OPT_TIMED * 1e3:.2f} ms/batch "
          f"host clock); launches (fp32, bf16) {launched}; the first "
          f"{BF16_ACT_ROWS} rows of a batch on the CPU ({t_cpu:.1f} s): raw "
          f"output bf16, max|card - CPU| {err:.3e} = {err / scale:.3e} of "
          f"max|ref| (held at 32u = {32 * U_BF16:.4f}), {flips} sign flips "
          f"where |logit| > 32u max|ref|")
    check(pred.dtype == bf16, "bf16 activations: the output is not bf16")
    check(err <= 32 * U_BF16 * scale and flips == 0,
          "bf16 activations: the query differs between card and CPU")
    check(all(v == (0, 0) for v in launched.values()),
          f"bf16 activations launched a kernel in the query: {launched}")
    res = {"qps": qps}

    m0 = copy.deepcopy(model)
    with torch.no_grad():
        for mod in m0.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    set_act_dtype(m0, bf16)
    tcfg = _train_cfg()
    pps, launched, _ = _train_rate(torch, np, device, m0, tcfg, n, pts_pad,
                                   queries, "bf16 act train")
    check(all(v == (0, 0) for v in launched.values()),
          f"bf16 activations launched a kernel in training: {launched}")
    res["pps"] = pps
    b = SLICE_TRAIN_BATCH
    gt = torch.from_numpy((np.random.RandomState(SEED + 41).randn(b)
                           * 0.05).astype(np.float32)).to(device)
    out, batch = [], None
    for dev in (device, cpu):
        m = copy.deepcopy(m0).to(dev)
        st = make_train_step(m, OUTPUTS, lr=0.01, momentum=0.9,
                             patch_cfg=tcfg)
        if batch is None:
            batch = st.extract_train_batch(pts_t, q_all[:b], n, gt,
                                           torch.Generator(
                                               device=device).manual_seed(1))
        t0 = time.perf_counter()
        losses, _ = st.train_step({k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        named = dict(m.named_parameters())
        out.append((losses.cpu(), {k: p.grad.cpu() for k, p in named.items()},
                    {k: p.detach().cpu() for k, p in named.items()},
                    time.perf_counter() - t0))
    (lg, gg, pg_, tg), (lc, gc, pc_, tc) = out
    names = [k for k in gc if not (k.endswith(".bias") and k.split(".")[
        -2].startswith(("conv", "fc")) and not k.startswith("fc4"))]
    a = torch.cat([gg[k].flatten() for k in names]).double()
    r = torch.cat([gc[k].flatten() for k in names]).double()
    cos = float(a @ r / a.norm() / r.norm())
    e_l = float(((lg - lc).abs() / lc.abs()).max())
    g_max = float(r.abs().max())
    e_p = max(float((pg_[k] - pc_[k]).abs().max()) for k in pc_)
    print(f"[bf16 act train] one step at batch {b} on the card's batch, card "
          f"({tg:.2f} s) vs CPU ({tc:.2f} s): losses {lg.tolist()} vs "
          f"{lc.tolist()}, max rel err {e_l:.3e} (rtol 32u = "
          f"{32 * U_BF16:.4f}); gradient cosine {cos:.4f} (> 0.85); updated "
          f"parameters max|err| {e_p:.3e} (within 2 lr max|g| = "
          f"{0.02 * g_max:.3e})")
    check(bool(torch.isfinite(lg).all()) and e_l <= 32 * U_BF16
          and cos > 0.85 and e_p <= 0.02 * g_max + 1e-7,
          "bf16 activations: the train step differs between card and CPU")
    return res


def phase_cli(torch, np, device, tmp):
    """Phase 10, the CLIs: ``full_train`` with the reference's default flags
    (ball mode, r = 0.05, 50 / 500 points, random order) but the
    experiments' outputs (CLI_OUTPUTS), one epoch and batch CLI_BATCH, on a
    copy of abc_minimal, then
    ``full_eval`` (the eval pass, the reconstruction at grid CLI_GRID, the
    meshes and both CSVs). Returns the kernels' launches."""
    import shutil

    from points2surf_tpu_torch.cli import full_eval, full_train
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.utils import mesh_io

    kernels = (chain_head, chain_pool, pooled_tail_reductions)
    root = os.path.join(tmp, "cli")
    data = os.path.join(root, "datasets", DRIVER_DATASET)
    shutil.copytree(os.path.join(ROOT, "datasets", DRIVER_DATASET), data,
                    ignore=shutil.ignore_patterns("cache"))
    models = os.path.join(root, "models")
    launched = {}
    torch.cuda.synchronize()
    _zero_launches(*kernels)
    t0 = time.perf_counter()
    full_train.main(["--name", "p2s_default", "--indir", data,
                     "--outdir", models, "--logdir", os.path.join(root, "logs"),
                     "--nepoch", "1", "--batchSize", str(CLI_BATCH),
                     "--outputs", *CLI_OUTPUTS])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launched["train"] = {f.__name__: f.launches for f in kernels}
    _zero_launches(*kernels)
    t0 = time.perf_counter()
    full_eval.main(["--indir", os.path.join(root, "datasets"),
                    "--dataset", f"{DRIVER_DATASET}/testset.txt",
                    "--outdir", os.path.join(root, "results"),
                    "--modeldir", models, "--models", "p2s_default",
                    "--query_grid_resolution", str(CLI_GRID),
                    "--epsilon", "3", "--sigma", str(MESH_SIGMA),
                    "--certainty_threshold", str(MESH_CERTAINTY),
                    "--batchSize", "1000"])
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launched["eval"] = {f.__name__: f.launches for f in kernels}
    res = os.path.join(root, "results", "p2s_default_model", DRIVER_DATASET)
    with open(os.path.join(data, "testset.txt")) as f:
        name = f.read().split()[0]
    verts, faces = mesh_io.load_mesh(os.path.join(res, "rec", "mesh",
                                                  name + ".ply"))
    hd = _csv_row(np, os.path.join(res, "rec", "hausdorff_dist_pred_rec.csv"),
                  name)
    mse = _csv_row(np, os.path.join(res, "eval", "rme_comp_res.csv"), name)
    print(f"[cli] full_train (reference defaults: patch_radius 0.05, 50 / "
          f"500 points; batch {CLI_BATCH}, 1 epoch, outputs {CLI_OUTPUTS}) "
          f"{t_train:.2f} s, launches "
          f"{launched['train']}; full_eval (eval pass, grid-{CLI_GRID} "
          f"reconstruction, meshing, CSVs) {t_eval:.2f} s, launches "
          f"{launched['eval']}; mesh {len(verts)} vertices, {len(faces)} "
          f"faces; eval CSV row {mse}; Hausdorff/Chamfer CSV row {hd}")
    check(launched["train"]["pooled_tail_reductions"] > 0
          and launched["eval"]["chain_pool"] > 0,
          "the CLIs did not launch the kernels")
    check(len(faces) > 0 and bool(np.isfinite(np.asarray(verts)).all()),
          "full_eval wrote no finite mesh")
    return launched


class _Calls:
    """Wraps functions that their callers look up on their module at each
    call while it lives: counts the calls and keeps the outputs of the
    first one; with ``timed``, the seconds of each call (ending in
    ``torch.cuda.synchronize()``) in call order."""

    def __init__(self, torch, targets, timed=False):
        self.torch, self.targets, self.timed = torch, targets, timed
        self.calls, self.first, self.seconds = {}, {}, {}

    def __enter__(self):
        self.real = [(mod, name, getattr(mod, name))
                     for mod, name in self.targets]
        for mod, name, fn in self.real:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.timed:
                self.torch.cuda.synchronize()
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            self.first.setdefault(name, out)
            return out
        return wrapper

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def _op_census(torch, fn):
    """(operations, bytes) of the eager PyTorch ops that ``fn()`` runs: an
    elementwise op counts one operation per output element (``addcmul``,
    the ray caster's FMA, two), a reduction one per input element; every
    op, dtype conversions included, reads the distinct elements of its
    tensor inputs (a broadcast operand once) and writes its outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    elementwise = {"add", "sub", "rsub", "mul", "div", "reciprocal", "abs",
                   "neg", "sqrt", "atan2", "lt", "le", "gt", "ge", "eq", "ne",
                   "where", "clamp", "clamp_min", "minimum", "maximum",
                   "isfinite"}
    reductions = {"sum", "amin", "argmin", "min", "topk"}
    views = {"view", "_unsafe_view", "expand", "slice", "select",
             "unsqueeze", "squeeze", "t", "transpose", "permute", "alias",
             "detach", "as_strided", "lift_fresh"}
    total = {"ops": 0.0, "bytes": 0.0}

    def distinct(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n * t.element_size()

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in views:
                return out
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if name in ("index", "gather"):  # reads what it writes
                total["bytes"] += 2 * sum(distinct(t) for t in outs)
            else:
                total["bytes"] += sum(distinct(t) for t in ins + outs)
            if name in elementwise:
                total["ops"] += outs[0].numel()
            elif name == "addcmul":
                total["ops"] += 2 * outs[0].numel()
            elif name in reductions:
                total["ops"] += ins[0].numel()
            return out

    with Census():
        fn()
    return total["ops"], total["bytes"]


def _two_best(torch, v, f, q, device, rows=256):
    """The least and second-least distance of each query over every face
    (all pairs, on the card)."""
    from points2surf_tpu_torch.ops import meshdist
    from points2surf_tpu_torch.ops.raycast import planes

    tri = torch.as_tensor(v[f], device=device)
    a, b, c = (planes(tri[None, :, k]) for k in range(3))
    qt = torch.as_tensor(q, device=device)
    best = []
    for r0 in range(0, len(q), rows):
        sq, _ = meshdist._point_triangle_closest(
            planes(qt[r0:r0 + rows, None]), a, b, c)
        best.append(sq.topk(2, dim=1, largest=False).values.sqrt())
    return torch.cat(best).cpu().numpy()


def _surface_hausdorff(np, a, b, device, n=50000):
    """Hausdorff distance of two meshes: exact point-to-mesh distances (on
    the card) of each mesh's vertices and ``n`` area-weighted surface
    samples to the other mesh."""
    from points2surf_tpu_torch.ops import meshdist

    worst = 0.0
    for (src, dst), seed in (((a, b), 0), ((b, a), 1)):
        pts = np.concatenate([src.sample_surface(
            n, np.random.RandomState(seed))[0], src.vertices])
        _, d, _ = meshdist.closest_point_on_mesh(dst.vertices, dst.faces,
                                                 pts, device=device)
        worst = max(worst, float(d.max()))
    return worst


def _datagen_ground_truth(torch, np, device, abc):
    """Phase 11, part 1: signed_distance on abc_minimal's 2,000 query points
    of each mesh against the reference's trimesh ground truth and against
    the CPU; closest_point_on_mesh card against CPU."""
    from points2surf_tpu_torch.ops import meshdist
    from points2surf_tpu_torch.utils import mesh_io

    for name in sorted(os.listdir(os.path.join(abc, "03_meshes"))):
        v, f = mesh_io.load_mesh(os.path.join(abc, "03_meshes", name))
        q = np.load(os.path.join(abc, "05_query_pts", name + ".npy"))
        gt = np.load(os.path.join(abc, "05_query_dist", name + ".npy"))
        d_g = meshdist.signed_distance(v, f, q, device=device)
        d_c = meshdist.signed_distance(v, f, q, device="cpu")
        err_gt = float(np.abs(np.clip(d_g, -1.0, 1.0) - gt).max())
        signs = float((np.sign(np.clip(d_g, -1.0, 1.0))
                       == np.sign(gt)).mean())
        err_cpu = float(np.abs(d_g - d_c).max())
        cp_g, dist_g, id_g = meshdist.closest_point_on_mesh(v, f, q,
                                                            device=device)
        cp_c, dist_c, id_c = meshdist.closest_point_on_mesh(v, f, q,
                                                            device="cpu")
        two = _two_best(torch, v, f, q, device)
        clear = (two[:, 1] - two[:, 0]) > 1e-6
        id_equal = bool((id_g[clear] == id_c[clear]).all())
        err_cp = float(np.abs(dist_g - dist_c).max())
        print(f"[datagen] {name}: {len(f)} faces, {len(q)} queries: "
              f"|card - trimesh GT| max {err_gt:.3e}, signs {signs:.2%}; "
              f"|card - CPU| max {err_cpu:.3e}; closest point distances "
              f"|card - CPU| max {err_cp:.3e}, points "
              f"{float(np.abs(cp_g - cp_c).max()):.3e}, face ids equal on "
              f"{int(clear.sum())} queries whose two best faces differ by "
              f"> 1e-6 ({int((id_g != id_c).sum())} differ overall)")
        check(err_gt <= 1e-4 and signs == 1.0,
              f"{name}: signed distance off the ground truth")
        check(err_cpu <= 1e-5, f"{name}: signed distance card != CPU")
        check(err_cp <= 1e-5 and id_equal,
              f"{name}: closest point card != CPU")


def _datagen_scan(torch, np, device, abc, settings):
    """Phase 11, part 2: every scan of the largest ABC mesh at 176 x 144 on
    the card (ms per scan, peak memory); its first scan on the CPU, held
    ray for ray."""
    from points2surf_tpu_torch.datagen import scanner
    from points2surf_tpu_torch.ops import raycast
    from points2surf_tpu_torch.utils import file_utils, mesh_io
    from points2surf_tpu_torch.utils.mesh import Mesh

    mesh_file = os.path.join(abc, "03_meshes", DATAGEN_BIG)
    mesh = Mesh(*mesh_io.load_mesh(mesh_file))
    locs, rots, sigma = scanner.scan_poses(
        mesh_file, settings["num_scans_per_mesh_min"],
        settings["num_scans_per_mesh_max"],
        settings["scanner_noise_sigma_min"],
        settings["scanner_noise_sigma_max"])
    seed = file_utils.filename_to_hash(mesh_file)
    scanner.scan_mesh(mesh, locs[:1], rots[:1], sigma, seed=seed,
                      device=device)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    target = [(raycast, "raycast_padded")]
    with _Calls(torch, target) as calls_g:
        t0 = time.perf_counter()
        p_g, n_g, h_g = scanner.scan_mesh(mesh, locs, rots, sigma, seed=seed,
                                          device=device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with _Calls(torch, target) as calls_c:
        t0 = time.perf_counter()
        p_c, n_c, h_c = scanner.scan_mesh(mesh, locs[:1], rots[:1], sigma,
                                          seed=seed, device="cpu")
        sec_cpu = time.perf_counter() - t0
    (t_g, id_g), (t_c, id_c) = (
        (t.cpu().numpy(), i.cpu().numpy())
        for t, i in (calls_g.first["raycast_padded"],
                     calls_c.first["raycast_padded"]))
    m_g = np.isfinite(t_g) & (t_g <= scanner.MAX_DISTANCE)
    m_c = np.isfinite(t_c) & (t_c <= scanner.MAX_DISTANCE)
    agree = float((m_g == m_c).mean())
    both = m_g & m_c
    same = both & (id_g == id_c)
    err_t = float(np.abs(t_g[same] - t_c[same]).max())
    rows_g = (np.cumsum(m_g) - 1)[same]
    rows_c = (np.cumsum(m_c) - 1)[same]
    err_p = float(np.abs(p_g[rows_g] - p_c[rows_c]).max())
    err_n = float(np.abs(n_g[rows_g] - n_c[rows_c]).max())
    rays = scanner.TOF_RES_X * scanner.TOF_RES_Y
    print(f"[datagen] scan {DATAGEN_BIG}: {len(mesh.faces)} faces, "
          f"{len(locs)} scans x {rays} rays, sigma {sigma:.5f}: "
          f"{1e3 * sec / len(locs):.2f} ms per scan on the card (host clock, "
          f"{calls_g.calls['raycast_padded']} raycast calls), {sum(h_g)} "
          f"points, peak {peak:.3f} GiB above the mesh; scan 0 on the CPU "
          f"{sec_cpu:.2f} s: hit masks agree on {agree:.4%} of rays, "
          f"{int(same.sum())} rays hit the same triangle on both, |t| max "
          f"{err_t:.3e}, points {err_p:.3e}, normals {err_n:.3e}")
    check(agree >= 0.999, f"scan hit masks agree on {agree:.4%} of rays")
    check(err_t <= 1e-5 and err_p <= 1e-5 and err_n <= 1e-6,
          "scan: t, points or normals card != CPU")
    check(calls_g.calls["raycast_padded"] == len(locs),
          "scan_mesh did not cast once per scan")


def _datagen_cli(torch, np, device, tmp, card):
    """Phase 11, part 3: ``cli/make_dataset.main`` with DATAGEN_MESHES
    procedural meshes at abc_minimal's settings, timed by stage and by
    mesh, its outputs checked; the distances of one mesh against the CPU;
    reconstruct_gt of that mesh at grid DATAGEN_GRID."""
    import shutil

    from points2surf_tpu_torch.cli import make_dataset as cli
    from points2surf_tpu_torch.datagen import make_dataset as mk
    from points2surf_tpu_torch.datagen import procedural, scanner
    from points2surf_tpu_torch.ops import meshdist, raycast
    from points2surf_tpu_torch.utils import mesh_io
    from points2surf_tpu_torch.utils.mesh import Mesh

    name = "proc_smoke"
    root = os.path.join(tmp, "datagen")
    ds = os.path.join(root, name)
    os.makedirs(ds)
    shutil.copy(os.path.join(ROOT, "datasets", DRIVER_DATASET,
                             "settings.ini"), ds)
    stages = [(procedural, "make_procedural_meshes")] + [
        (mk, s) for s in ("convert_meshes", "clean_meshes",
                          "normalize_meshes", "sample_scans",
                          "get_query_pts_dist_ms", "make_dataset_splits")]
    per_mesh = [(scanner, "scan_mesh"), (mk, "_get_and_save_query_pts")]
    ops = [(raycast, "raycast_padded"), (meshdist, "signed_distance_padded"),
           (meshdist, "closest_point_padded")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Calls(torch, stages, timed=True) as st, \
            _Calls(torch, per_mesh, timed=True) as pm, \
            _Calls(torch, ops) as op:
        cli.main(["--name", name, "--base_dir", root, "--procedural",
                  str(DATAGEN_MESHES)], device=device)
    total = time.perf_counter() - t0
    print(f"[datagen] make_dataset CLI: {DATAGEN_MESHES} procedural meshes "
          f"at {DRIVER_DATASET}'s settings.ini, {total:.2f} s on {card}; "
          "by stage (s): " + ", ".join(
              f"{k} {sum(v):.2f}" for k, v in st.seconds.items()))
    for stage in DATAGEN_STAGES:
        n = len(os.listdir(os.path.join(ds, stage)))
        check(n == DATAGEN_MESHES, f"{stage} holds {n} files")
    for split in ("trainset.txt", "valset.txt", "testset.txt"):
        check(os.path.isfile(os.path.join(ds, split)), f"no {split}")
    meshes = {}
    # sample_scans and get_query_pts_dist_ms take the meshes in this order
    for i, f in enumerate(sorted(os.listdir(os.path.join(ds, "03_meshes")))):
        m = Mesh(*mesh_io.load_mesh(os.path.join(ds, "03_meshes", f)))
        scans = len(np.load(os.path.join(ds, "04_pts_locations",
                                         f[:-4] + ".npz"))["locations"])
        pts = np.load(os.path.join(ds, "04_pts", f[:-4] + ".xyz.npy"))
        meshes[f] = m
        print(f"[datagen]   {f}: {len(m.faces)} faces, {scans} scans "
              f"{pm.seconds['scan_mesh'][i]:.3f} s, {len(pts)} points; "
              f"2,000 queries "
              f"{pm.seconds['_get_and_save_query_pts'][i]:.3f} s")
    print(f"[datagen] device op calls in the CLI run: {op.calls} "
          f"(one raycast per scan, one distance call per mesh)")
    big = [f for f, m in meshes.items() if len(m.faces) >= 1000]
    one = min(big, key=lambda f: len(meshes[f].faces)) if big else \
        max(meshes, key=lambda f: len(meshes[f].faces))
    m = meshes[one]
    q = np.load(os.path.join(ds, "05_query_pts", one + ".npy"))
    d_ds = np.load(os.path.join(ds, "05_query_dist", one + ".npy"))
    d_cpu = np.clip(meshdist.signed_distance(m.vertices, m.faces, q,
                                             device="cpu"), -1.0, 1.0)
    err = float(np.abs(d_ds - d_cpu).max())
    print(f"[datagen] {one}: the dataset's distances against the CPU's: "
          f"max {err:.3e}")
    check(err <= 1e-5, f"{one}: the dataset's distances != the CPU's")

    rgt = os.path.join(tmp, "datagen_rgt")
    os.makedirs(os.path.join(rgt, "ds", "03_meshes"))
    shutil.copy(os.path.join(ds, "03_meshes", one),
                os.path.join(rgt, "ds", "03_meshes"))
    t0 = time.perf_counter()
    mk.reconstruct_gt(rgt, "ds", grid_resolution=DATAGEN_GRID,
                      device=device)
    t_rgt = time.perf_counter() - t0
    rec = Mesh(*mesh_io.load_mesh(os.path.join(
        rgt, "ds", "06_reconstruction_gt", one)))
    hd = _surface_hausdorff(np, m, rec, device)
    tight = len(rec.faces) > 0 and _watertight(np, rec.faces)
    # the volume spans [-1, 1]^3 (ops/voxel.py), so a voxel is 2 / grid
    voxel = 2.0 / DATAGEN_GRID
    print(f"[datagen] reconstruct_gt {one} at grid {DATAGEN_GRID} (100,000 "
          f"GT queries): {t_rgt:.2f} s, {len(rec.faces)} faces, watertight "
          f"{tight}, Hausdorff to the input {hd:.5f} = {hd / voxel:.3f} "
          f"voxels of {voxel} (exact point-to-mesh distances of each mesh's "
          f"vertices and 50,000 surface samples)")
    check(tight, "reconstruct_gt's mesh is not watertight")
    check(hd <= 2.0 * voxel,
          f"reconstruct_gt: Hausdorff {hd:.5f} > 2 voxels")
    return ds, op.calls


def _datagen_train(torch, np, device, tmp, ds):
    """Phase 11, part 4: one epoch of the port's full_train on the generated
    dataset at the reference's defaults (ball mode, r = 0.05) with batch
    DRIVER_BATCH and DATAGEN_PATCHES patches per shape; pooled_tail
    launches one per trunk and encoder per step."""
    from points2surf_tpu_torch.cli import full_train
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)

    with open(os.path.join(ds, "trainset.txt")) as f:
        train = [ln.strip() for ln in f if ln.strip()]
    n_patches = sum(min(DATAGEN_PATCHES, len(np.load(os.path.join(
        ds, "05_query_dist", s + ".ply.npy"), mmap_mode="r")))
        for s in train)
    steps = -(-n_patches // DRIVER_BATCH)
    torch.cuda.synchronize()
    _zero_launches(pooled_tail_reductions)
    t0 = time.perf_counter()
    full_train.main(["--name", "p2s_datagen", "--indir", ds,
                     "--outdir", os.path.join(tmp, "datagen_models"),
                     "--logdir", os.path.join(tmp, "datagen_logs"),
                     "--nepoch", "1", "--batchSize", str(DRIVER_BATCH),
                     "--patches_per_shape", str(DATAGEN_PATCHES),
                     "--outputs", *CLI_OUTPUTS])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = pooled_tail_reductions.launches
    print(f"[datagen] full_train on the generated dataset ({len(train)} "
          f"train shapes, reference defaults, batch {DRIVER_BATCH}, "
          f"{DATAGEN_PATCHES} patches per shape, 1 epoch): {steps} steps in "
          f"{sec:.2f} s, pooled_tail launches {launches}")
    check(os.path.isfile(os.path.join(tmp, "datagen_models",
                                      "p2s_datagen_model.npz")),
          "full_train wrote no checkpoint")
    check(launches == 5 * steps,
          f"pooled_tail launched {launches} times, not 5 per step over "
          f"{steps} steps")
    return launches


def _datagen_ops(torch, np, device, card, abc, settings, calls):
    """Phase 11, part 5: each device op at phase 11's shapes on the largest
    ABC mesh (one full scan's rays; the 2,000 query points): ms per call
    (CUDA events), peak memory, the operations and bytes of the eager ops
    it runs, and its bound."""
    from points2surf_tpu_torch.datagen import scanner
    from points2surf_tpu_torch.ops import meshdist, raycast
    from points2surf_tpu_torch.utils import mesh_io

    mesh_file = os.path.join(abc, "03_meshes", DATAGEN_BIG)
    v, f = mesh_io.load_mesh(mesh_file)
    q = torch.as_tensor(np.load(os.path.join(
        abc, "05_query_pts", DATAGEN_BIG + ".npy")), device=device)
    locs, rots, _ = scanner.scan_poses(
        mesh_file, settings["num_scans_per_mesh_min"],
        settings["num_scans_per_mesh_max"],
        settings["scanner_noise_sigma_min"],
        settings["scanner_noise_sigma_max"])
    rot = scanner._quat_to_rotmat_np(rots[0])
    dirs = torch.as_tensor((scanner._frustum_dirs() @ rot).astype(
        np.float32), device=device)
    origins = torch.as_tensor((rot.T @ (-locs[0])).astype(np.float32),
                              device=device).expand(dirs.shape)
    tri = raycast.pad_triangles(v, f, device=device)
    n_tris = tri[3]
    rays = dirs.shape[0]
    fns = {
        "raycast_padded": (lambda: raycast.raycast_padded(origins, dirs,
                                                          *tri),
                           rays, 24 * rays + 8 * rays),
        "signed_distance_padded": (
            lambda: meshdist.signed_distance_padded(q, *tri), len(q),
            12 * len(q) + 8 * len(q)),
        "closest_point_padded": (
            lambda: meshdist.closest_point_padded(q, *tri), len(q),
            12 * len(q) + 20 * len(q)),
    }
    out = {}
    for name, (fn, rows, io_bytes) in fns.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = _events_ms(torch, fn, DATAGEN_TIMED)
        ops, moved = _op_census(torch, fn)
        padded = rows * tri[0].shape[0]
        per_pair = ops / padded
        pairs = rows * n_tris
        min_bytes = io_bytes + 36 * n_tris
        bound_ms, bound_by = _bound(per_pair * pairs, min_bytes,
                                    PEAK_FLOPS_FP32)
        out[name] = {
            "rows": rows, "triangles": n_tris, "padded": tri[0].shape[0],
            "ms": ms, "peak_gib": peak, "ops_per_pair": per_pair,
            "unfused_bytes_per_pair": moved / padded,
            "unfused_bytes_ms": 1e3 * moved / PEAK_BYTES,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "calls_in_cli": calls.get(name, 0)}
    print(f"[datagen] device ops at phase 11's shapes ({DATAGEN_BIG}, "
          f"{n_tris} triangles padded to {tri[0].shape[0]}; fp32 bound at "
          f"67 TFLOP/s, bytes at 3.35 TB/s; {card}): {json.dumps(out)}")


def phase_datagen(torch, np, device, tmp, card):
    """Phase 11: dataset generation on the card (parts 1-5 above). Returns
    the training epoch's pooled_tail launches."""
    from points2surf_tpu_torch.datagen import make_dataset as mk

    t0 = time.perf_counter()
    abc = os.path.join(ROOT, "datasets", DRIVER_DATASET)
    settings = mk.read_settings(os.path.join(ROOT, "datasets"),
                                DRIVER_DATASET)
    _datagen_ground_truth(torch, np, device, abc)
    _datagen_scan(torch, np, device, abc, settings)
    ds, calls = _datagen_cli(torch, np, device, tmp, card)
    launches = _datagen_train(torch, np, device, tmp, ds)
    _datagen_ops(torch, np, device, card, abc, settings, calls)
    _card_state("datagen")
    print(f"[datagen] phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches


def _zero_transformers(torch, model):
    """The spatial transformers' last layers at zero (their output is then
    the identity): phase 5's remedy for near-tied max-pool args."""
    from points2surf_tpu_torch.models.pointnet import _STNTrunk

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    return model


class _ArgRecorder:
    """Keeps the max / min arg indices of every ``pooled_tail_reductions``
    call of the model (``models/pointnet``) while it is entered."""

    def __init__(self, pn):
        self.pn, self.args = pn, []

    def __enter__(self):
        self.real = real = self.pn.pooled_tail_reductions

        def tail(x, w, b):
            out = real(x, w, b)
            self.args.append((out[1].cpu(), out[3].cpu()))
            return out

        self.pn.pooled_tail_reductions = tail
        return self

    def __exit__(self, *exc):
        self.pn.pooled_tail_reductions = self.real


def _parallel_steps(torch, device, job, world, lo, hi, starts=None):
    """PARALLEL_STEPS fused steps of the job's model on rows lo:hi of the
    job's global batches (draws of one seeded generator on the card, each
    rank drawing the whole batch and keeping its rows): losses, the first
    step's gradients, the state after the last step, the arg indices, and
    the parameters, running statistics and momentum before each step.
    With ``starts`` (those of another run), each step starts from them."""
    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.ops.patches import draw_batch
    from points2surf_tpu_torch.parallel import replicate
    from points2surf_tpu_torch.train.trainer import make_train_step

    model = PointsToSurfModel(net_size_max=NET, output_dim=2,
                              shared_transformation=True)
    model.load_state_dict(job["state"])
    model = replicate(model.to(device))
    cfg = _train_cfg()
    steps = make_train_step(model, OUTPUTS, lr=0.01, momentum=0.9,
                            patch_cfg=cfg)
    pts = job["pts"].to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    out = {"losses": [], "starts": []}
    with _ArgRecorder(pn) as rec:
        for i in range(PARALLEL_STEPS):
            if starts is not None and starts[i] is not None:
                model.load_state_dict(starts[i][0])
                steps.load_sgd_state(starts[i][1], None)
            opt_state = steps.optimizer.state
            out["starts"].append(None if i == 0 else (
                {k: v.cpu().clone() for k, v in model.state_dict().items()},
                {k: opt_state[p]["momentum_buffer"].cpu().clone()
                 for k, p in model.named_parameters()}))
            q, gt = job["q"][i], job["gt"][i]
            draws = draw_batch(gen, len(q), pts.shape[0], cfg, train=True,
                               n_valid=job["n"])
            if world > 1:
                draws = draws.rows(lo, hi, chunk=cfg.query_chunk)
            losses, _ = steps.train_step_fused(
                pts, q[lo:hi].to(device), job["n"], gt[lo:hi].to(device),
                draws)
            out["losses"].append(losses.cpu())
            if i == 0:
                out["grads"] = {k: p.grad.cpu().clone()
                                for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    out["state"] = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    out["args"] = rec.args
    return out, steps, pts, gen


def _parallel_worker(rank: str, world: str, work: str) -> int:
    """One rank of phase 12 (``chip_smoke.py --parallel-rank R W DIR``): joins
    the gloo group through the ``file://`` store in DIR, runs the fused
    steps on its rows of the job's batches, times its steps and their
    all-reduces, runs its share of the evaluator, and saves what it saw to
    DIR/rank<R>.pt."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK="0")
    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.cli import eval_args
    from points2surf_tpu_torch.infer import evaluator
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.ops.patches import draw_batch
    from points2surf_tpu_torch.parallel import distributed

    job = torch.load(os.path.join(work, "job.pt"), weights_only=False)
    device = torch.device(job["device"])
    check(distributed.initialize(backend="gloo",
                                 init_method="file://" + os.path.join(
                                     work, "store")),
          "initialize() did not join the group")
    r, w = distributed.rank(), distributed.world_size()
    lo, hi = distributed.rank_rows(TRAIN_BATCH)
    res = {"rows": (lo, hi)}
    pooled_tail_reductions.launches = 0
    with _Recorder(pn) as sites:
        out, steps, pts, gen = _parallel_steps(torch, device, job, w, lo, hi)
        res.update(out, launches=pooled_tail_reductions.launches)
        # ms per step and all-reduce share: PARALLEL_TIMED steps as they
        # run, then as many with a synchronize and the host clock around
        # each all-reduce
        q_all = job["q_timed"].to(device)
        gt = job["gt"][0][lo:hi].to(device)
        cfg = steps.patch_cfg
        real = torch.distributed.all_reduce
        spent = [0.0, 0]

        def timed(t, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ret = real(t, *a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return ret

        secs = []
        for instrument in (False, True):
            distributed.barrier("timed steps")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if instrument:
                torch.distributed.all_reduce = timed
            try:
                for i in range(PARALLEL_TIMED):
                    q = q_all[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                    draws = draw_batch(
                        gen, TRAIN_BATCH, pts.shape[0], cfg, train=True,
                        n_valid=job["n"]).rows(lo, hi, chunk=cfg.query_chunk)
                    steps.train_step_fused(pts, q[lo:hi], job["n"], gt,
                                           draws)
                torch.cuda.synchronize()
            finally:
                torch.distributed.all_reduce = real
            secs.append(time.perf_counter() - t0)
        res["timed_launches"] = pooled_tail_reductions.launches
        res["step_s"], res["instrumented_step_s"] = (
            s / PARALLEL_TIMED for s in secs)
        res["allreduce_s"] = spent[0] / PARALLEL_TIMED
        res["allreduce_calls"] = spent[1] / PARALLEL_TIMED
        # this rank's share of the evaluator (the group's by default)
        for f in (chain_head, chain_pool):
            f.launches = 0
        _parallel_eval(torch, evaluator, eval_args, job["eval"], device,
                       os.path.join(work, f"eval_rank{r}"))
        torch.cuda.synchronize()
        res["eval_launches"] = {"chain_head": chain_head.launches,
                                "chain_pool": chain_pool.launches}
    # each kernel against its plain version at this rank's call sites
    res["err"] = _driver_sites_check(torch, sites, f"parallel rank {r}")
    torch.save(res, os.path.join(work, f"rank{r}.pt"))
    distributed.barrier("done")
    torch.distributed.destroy_process_group()
    return 0


def _parallel_eval(torch, evaluator, eval_args, spec, dev, outdir,
                   shard=None):
    """``points_to_surf_eval`` on the job's three-shape dataset, the
    reconstruction and the eval pass, with draws of a seeded CPU generator
    moved to ``dev``; ``shard`` None takes the process group's share."""
    real_draw = evaluator.draw_batch
    gen = torch.Generator().manual_seed(SEED + 12)

    def draw(g, b, n, cfg, small_cloud=False, train=False, n_valid=None):
        return real_draw(gen, b, n, cfg, small_cloud, train,
                         n_valid).to(dev)

    evaluator.draw_batch = draw
    try:
        for extra in (["--reconstruction", "True", "--query_grid_resolution",
                       str(DRIVER_GRID), "--epsilon", "3"], []):
            evaluator.points_to_surf_eval(eval_args.parse_arguments(
                spec["args"] + ["--outdir", outdir] + extra), device=dev,
                shard=shard)
    finally:
        evaluator.draw_batch = real_draw


def _parallel_eval_data(np, data, tmp):
    """The three abc_minimal shapes in one split file, each cut to its
    first n_q GT queries (the eval pass) and the same points cached as its
    grid queries (the reconstruction), as phase 8 cuts its first batches."""
    import shutil

    n_q = DRIVER_BATCH + DRIVER_BATCH // 2
    root = os.path.join(tmp, "parallel_eval_data")
    for sub in ("04_pts", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, sub))
    names = sorted(f[:-len(".xyz.npy")]
                   for f in os.listdir(os.path.join(data, "04_pts")))
    cache = os.path.join(root, "cache", f"grid_queries_r{DRIVER_GRID}_e3")
    os.makedirs(cache)
    for name in names:
        shutil.copy(os.path.join(data, "04_pts", name + ".xyz.npy"),
                    os.path.join(root, "04_pts"))
        for sub in ("05_query_pts", "05_query_dist"):
            np.save(os.path.join(root, sub, name + ".ply.npy"), np.load(
                os.path.join(data, sub, name + ".ply.npy"))[:n_q])
        np.save(os.path.join(cache, name + ".npy"), np.load(os.path.join(
            data, "05_query_pts", name + ".ply.npy"))[:n_q])
        t_pts = os.path.getmtime(os.path.join(root, "04_pts",
                                              name + ".xyz.npy"))
        os.utime(os.path.join(cache, name + ".npy"), (t_pts + 10, t_pts + 10))
    with open(os.path.join(root, "all.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return root, names, n_q


def _run_ranks(work, world):
    """Start ``world`` ranks of this script on the card; fail, and stop
    every rank, when one fails or PARALLEL_TIMEOUT passes."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(world)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(world), work], cwd=ROOT, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"rank{r}.log")) as f:
            tail = f.read()[-6000:]
        print(f"[parallel] rank {r} exit {p.returncode}; its last output:\n"
              + "\n".join("[parallel]   " + ln for ln in tail.splitlines()))
    codes = [p.returncode for p in procs]
    check(codes == [0] * world, f"phase 12: a rank failed or timed out "
                                f"(exit codes {codes})")


def phase_parallel(torch, np, device, model, pts_pad, n, queries, drv, tmp,
                   card):
    """Phase 12: data parallelism (``parallel/``). Two gloo ranks share the
    card, each with half of phase 6's batch of TRAIN_BATCH, against the
    one-process step on the whole batch; each rank's share of the
    evaluator against the CPU; a world of one launches no collective."""
    import points2surf_tpu_torch.models.pointnet as pn
    from points2surf_tpu_torch.cli import eval_args
    from points2surf_tpu_torch.infer import evaluator

    t0 = time.perf_counter()
    world = PARALLEL_RANKS
    work = os.path.join(tmp, "parallel")
    os.makedirs(work)
    rs = np.random.RandomState(SEED + 12)
    model = _zero_transformers(torch, copy.deepcopy(model).cpu())
    steps_q = [torch.from_numpy(queries[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(PARALLEL_STEPS)]
    data, names, n_q = _parallel_eval_data(
        np, os.path.join(tmp, "datasets", DRIVER_DATASET), tmp)
    job = {
        "device": str(device),
        "state": model.state_dict(), "pts": torch.from_numpy(pts_pad),
        "n": n, "q": steps_q,
        "gt": [torch.from_numpy((rs.randn(TRAIN_BATCH) * 0.05).astype(
            np.float32)) for _ in range(PARALLEL_STEPS)],
        "q_timed": torch.from_numpy(queries[-PARALLEL_TIMED * TRAIN_BATCH:]),
        "eval": {"args": ["--indir", data, "--dataset", "all.txt",
                          "--models", "vanilla", "--modeldir", drv["models"],
                          "--batchSize", str(DRIVER_BATCH),
                          "--cache_capacity", "5"]},
    }
    torch.save(job, os.path.join(work, "job.pt"))

    # the one-process step on the whole batch, with no process group: it
    # must launch no collective
    check(not torch.distributed.is_initialized(),
          "a process group exists in the one-process run")
    calls = []
    real = {k: getattr(torch.distributed, k)
            for k in ("all_reduce", "broadcast", "barrier")}

    def counting(name):
        def f(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return f

    # the ranks share the card with this process: hand its cached blocks
    # back first
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[parallel] starting {world} ranks; the card has "
          f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
    _run_ranks(work, world)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    # each one-process step starts where the ranks' step started: the
    # transformers leave the identity after the first step, and from then
    # on they amplify rounding tenfold and flip near-tied max-pool args
    # (phase 5), so free-running steps part by more than rounding. Its
    # tails take the ranks' arg indices where each is an arg of its own
    # values (phase 5's replay): a near-tie decided the other way routes a
    # row's gradient elsewhere, which is not what this phase tests
    stats = {"args": 0, "own_differs": 0, "bad": 0}
    queue = [tuple(torch.cat([res["args"][j][m] for res in ranks])
                   for m in (0, 1)) for j in range(len(ranks[0]["args"]))]
    real_tail = pn.pooled_tail_reductions

    def replay(x, w, bias):
        cmax, amax, cmin, amin, rsum, rsq = real_tail(x, w, bias)
        pooled = []
        for own, val, g in ((amax, cmax, queue[0][0]),
                            (amin, cmin, queue[0][1])):
            g = g.to(x.device)
            rows = torch.gather(x, 1, g.long()[:, :, None].expand(
                -1, -1, x.shape[2]))  # (B, C, Cin)
            at = torch.einsum("bci,ic->bc", rows, w) + bias
            tol = 1e-4 * float(val.abs().max())
            stats["args"] += g.numel()
            stats["own_differs"] += int((own != g).sum())
            stats["bad"] += int(((at - val).abs()
                                 > tol + 1e-4 * val.abs()).sum())
            pooled.append((at, g))
        queue.pop(0)
        return pooled[0][0], pooled[0][1], pooled[1][0], pooled[1][1], \
            rsum, rsq

    for k in real:
        setattr(torch.distributed, k, counting(k))
    pn.pooled_tail_reductions = replay
    try:
        one, _, _, _ = _parallel_steps(torch, device, job, 1, 0,
                                       TRAIN_BATCH, ranks[0]["starts"])
    finally:
        pn.pooled_tail_reductions = real_tail
        for k, f in real.items():
            setattr(torch.distributed, k, f)
    print(f"[parallel] one process, batch {TRAIN_BATCH}, {PARALLEL_STEPS} "
          f"fused steps (each from the ranks' state before it): losses "
          f"{[v.tolist() for v in one['losses']]}; collectives launched "
          f"{len(calls)} (no process group)")
    check(not calls, "the one-process step launched a collective")
    for r, res in enumerate(ranks):
        per = res["rows"][1] - res["rows"][0]
        check(per * world == TRAIN_BATCH, f"rank {r} took rows {res['rows']}")
        n_steps = PARALLEL_STEPS
        check(res["launches"] == 5 * n_steps
              and res["timed_launches"] == 5 * (n_steps + 2 * PARALLEL_TIMED),
              f"rank {r}: pooled_tail launched {res['launches']} times in "
              f"{n_steps} steps ({res['timed_launches']} with the timed "
              f"ones), not 5 per step")
    # the state after the last step, bit for bit on every rank
    same = all(torch.equal(res["state"][k], v) for res in ranks[1:]
               for k, v in ranks[0]["state"].items())
    print(f"[parallel] {world} gloo ranks on one card, {TRAIN_BATCH // world} "
          f"rows each: parameters and running statistics after step "
          f"{PARALLEL_STEPS} bit-identical on every rank: {same}; "
          f"pooled_tail launches per rank {[r['launches'] for r in ranks]} "
          f"in {PARALLEL_STEPS} steps")
    check(same, "the ranks' states differ")
    worst = 0.0
    for i in range(PARALLEL_STEPS):
        mean = sum(r["losses"][i] for r in ranks).double() / world
        err = float(((mean - one["losses"][i].double()).abs()
                     / one["losses"][i].double().abs()).max())
        worst = max(worst, err)
        print(f"[parallel] step {i + 1}: losses (mean over ranks) "
              f"{mean.tolist()} vs one process {one['losses'][i].tolist()}: "
              f"max rel err {err:.3e} (rtol 1e-4)")
    # the first step's gradients, every element within 1e-3 of the model's
    # largest gradient; per tensor, relative to its own largest, for the
    # record (a ReLU input or a sub-sample key within rounding of a tie
    # moves a tensor's gradient by more than rounding)
    g_max = max(float(g.abs().max()) for g in one["grads"].values())
    bad, g_worst, own = [], 0.0, (0.0, "")
    for k, g in one["grads"].items():
        e = float((ranks[0]["grads"][k] - g).abs().max())
        g_worst = max(g_worst, e / g_max)
        if float(g.abs().max()) >= 1e-6 * g_max:
            own = max(own, (e / float(g.abs().max()), k))
        if e > 1e-3 * g_max:
            bad.append(k)
    print(f"[parallel] step 1 gradients of {len(one['grads'])} tensors: "
          f"worst max|err| / max|g| over the model {g_worst:.3e} (gate "
          f"1e-3), outside {bad[:5]}; worst relative to its own tensor's "
          f"max|g| {own[0]:.3e} ({own[1]})")
    print(f"[parallel] max / min arg indices of the {PARALLEL_STEPS} steps' "
          f"tails: the one-process step's own differ from the ranks' in "
          f"{stats['own_differs']} of {stats['args']} (near-ties under "
          f"another summation order; it took the ranks'), and the ranks' "
          f"index is not an arg of its values in {stats['bad']}")
    check(not queue and stats["bad"] == 0,
          "a rank's arg index is not an arg of the one-process values, or "
          "the runs made different numbers of tail calls")
    check(worst <= 1e-4, "the ranks' losses differ from the one-process step")
    check(not bad, "the ranks' gradients differ from the one-process step")

    # the evaluator: every shape once over the ranks, each rank's files
    # against the CPU port run with the same (rank, world)
    sub = os.path.join("rec", "dist_ms"), os.path.join("eval", "eval")
    seen = []
    for r in range(world):
        out_card = os.path.join(work, f"eval_rank{r}")
        out_cpu = os.path.join(work, f"eval_cpu_rank{r}")
        _parallel_eval(torch, evaluator, eval_args, job["eval"],
                       torch.device("cpu"), out_cpu, shard=(r, world))
        check(_files(out_card) == _files(out_cpu),
              f"rank {r}: the card and the CPU wrote different files")
        for d in sub:
            for f in sorted(os.listdir(os.path.join(out_card, d))):
                if not f.endswith(".xyz.npy"):
                    continue
                seen.append((d, f))
                g, c = (np.load(os.path.join(o, d, f))
                        for o in (out_card, out_cpu))
                check(g.shape == c.shape == (n_q,), f"{d}/{f}: {g.shape}")
                e = np.abs(g - c)
                nbad = int((e > 1e-4 + 1e-3 * np.abs(c)).sum())
                flips = int(((np.sign(g) != np.sign(c))
                             & (np.abs(c) > 1e-4)).sum())
                print(f"[parallel eval] rank {r} {d}/{f[:12]}: card vs CPU "
                      f"max_abs_err {float(e.max()):.3e}, {nbad} outside "
                      f"rtol 1e-3 / atol 1e-4, sign flips {flips}")
                check(nbad == 0 and flips == 0,
                      f"rank {r}'s evaluator differs from the CPU's")
    want = sorted((d, nm + ".xyz.npy") for d in sub for nm in names)
    print(f"[parallel eval] {len(seen)} distance files over {world} ranks "
          f"for {len(names)} shapes x 2 passes; chain launches per rank "
          f"{[r['eval_launches'] for r in ranks]}")
    check(sorted(seen) == want, "the ranks did not write every shape once")
    step_ms = [1e3 * r["step_s"] for r in ranks]
    share = [r["allreduce_s"] / r["instrumented_step_s"] for r in ranks]
    print(f"[parallel] {world} ranks on one card ({card}), "
          f"{TRAIN_BATCH // world} rows each, {PARALLEL_TIMED} timed steps: "
          f"ms per step {step_ms} (host clock), patches/s per rank "
          f"{[TRAIN_BATCH // world / (ms / 1e3) for ms in step_ms]}; "
          f"all-reduces per step {[r['allreduce_calls'] for r in ranks]}, "
          f"their share of an instrumented step (a synchronize and the host "
          f"clock around each) {share}, "
          f"{[1e3 * r['allreduce_s'] for r in ranks]} ms per step. One card "
          f"shared by two processes: not a scaling result")
    err = {k: max(r["err"][k] for r in ranks) for k in ranks[0]["err"]}
    print(f"[parallel] phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"launches": sum(r["launches"] for r in ranks),
            "eval_launches": {k: sum(r["eval_launches"][k] for r in ranks)
                              for k in ("chain_head", "chain_pool")},
            "err": err}


def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:
        return _parallel_worker(*sys.argv[2:5])
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
        t10 = time.perf_counter()
        opt_err = phase_option_kernels(torch, device)
        ball = phase_ball(torch, np, device, model, pts_pad, n, queries)
        uni = phase_uniform(torch, np, device, pts_pad, n, queries)
        b16 = phase_bf16_act(torch, np, device, model, pts_pad, n, queries)
        cli = phase_cli(torch, np, device, tmp)
        print(f"[options] phase 10 took {time.perf_counter() - t10:.1f} s: "
              f"ball queries/s {ball['qps']}, uniform train patches/s "
              f"{uni['pps']}, bf16 activations {b16}")
        gen_launches = phase_datagen(torch, np, device, tmp, card)
        par = phase_parallel(torch, np, device, model, pts_pad, n, queries,
                             drv, tmp, card)
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
    # the bf16 query, train step and reconstruction of phase 9; phase 10's
    # ball-mode queries, uniform-mode train steps and CLI run; phase 11's
    # training epoch on the generated dataset; phase 12's ranks, summed:
    # their train steps and their shares of the evaluator; each counted
    # from 0 just before it), launches_by_path splits them. max_abs_err
    # takes phase 10's call sites (n = 1200 and 75, ball mode) and phase
    # 12's (each rank's rows) too.
    dl = drv["launches"]

    def cli_count(name):
        return cli["train"][name] + cli["eval"][name]

    by_path = {
        "chain_head": {"query": launches["chain_head"],
                       "mesh": mesh_launches["chain_head"],
                       "driver": dl["chain_head"],
                       "ball_query": ball["launches"]["chain_head"],
                       "cli": cli_count("chain_head"),
                       "parallel_eval": par["eval_launches"]["chain_head"]},
        "chain_pool": {"query": launches["chain_pool"],
                       "mesh": mesh_launches["chain_pool"],
                       "driver": dl["chain_pool"],
                       "ball_query": ball["launches"]["chain_pool"],
                       "cli": cli_count("chain_pool"),
                       "parallel_eval": par["eval_launches"]["chain_pool"]},
        "pooled_tail": {"train": tail_launches, "driver": dl["pooled_tail"],
                        "uniform_train": uni["launches"],
                        "cli": cli_count("pooled_tail_reductions"),
                        "datagen_train": gen_launches,
                        "parallel": par["launches"]},
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
         max(kern["err"]["chain_head"], drv["err"]["chain_head"],
             opt_err["chain_head"], ball["err"]["chain_head"],
             par["err"]["chain_head"]), q["head"],
         q["head_plain"], *q["head_cost"]),
        ("chain_pool", "chain_pool.cu", "chain_kernel.py:187",
         max(kern["err"]["chain_pool"], drv["err"]["chain_pool"],
             opt_err["chain_pool"], ball["err"]["chain_pool"],
             par["err"]["chain_pool"]), q["tail"],
         q["tail_plain"], *q["tail_cost"]),
        ("pooled_tail", "pooled_tail.cu", "train_tail.py:138",
         max(tail["max_abs_err"], drv["err"]["pooled_tail"],
             opt_err["pooled_tail"], ball["err"]["pooled_tail"],
             par["err"]["pooled_tail"]), tail["ms"],
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
