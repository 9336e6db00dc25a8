"""Run one cell of the benchmark once, on the card of this machine:

    python3 p2s_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's files are found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic driver
(``traffic/<traffic>.py``), the driver's parameters and the limits of the
check; ``BENCHMARK.json`` at the root of the checkout names the metrics the
cell reports, and each per-layer metric is read by ``layer_metrics/<metric>
.py``. Set-up (everything before the window: imports, the CUDA context, the
kernel builds or loads, the weights, the data and the warm-up) is timed from
the start of this script; the window runs ``--seconds``; with ``--trace 1``
the profiler traces the whole window and the per-layer metrics are read
from it. After the window the program's state is freed and the plain
reference judges what the window produced.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``) and, last, ``checks``: each compared number with its limit,
which are also the last lines of standard error. A run without a CUDA card,
or in which a module of JAX or of the JAX package was loaded, exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, the port

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics BENCHMARK.json has this cell report: its end-to-end
    metrics, or with ``trace`` its per-layer metrics (those listing the
    cell, and those without a list that move one of its end-to-end
    metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def prebuild() -> None:
    """Build (first run in a checkout) or find (every later run) each CUDA
    source of the program and the marching library, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from points2surf_tpu_torch.ops import marching_native
    from points2surf_tpu_torch.ops.kernels import build

    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names) + 1) as ex:
        jobs = [ex.submit(build.build_library, n) for n in names]
        jobs.append(ex.submit(marching_native.build_library))
        for job in jobs:
            job.result()


def judge(checks, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    at or under its limit (a NaN is not)."""
    out, ok = {}, True
    for name, value in checks:
        limit = limits[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, out


def forbidden_none() -> bool:
    """True when no module of JAX or of the JAX package is loaded; else says
    on standard error what is."""
    found = harness.forbidden_loaded()
    if found:
        print(f"no result: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
    return not found


def drive(workload: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda", cfg: dict | None = None) -> dict | None:
    """Set up the cell, run its window, free the program, judge its outputs.
    Returns the result line, or None (after saying why on standard error)
    when a module of JAX or of the JAX package was loaded. ``device`` and
    ``cfg`` (another configuration than the cell's file) serve the tests,
    which drive a run on the CPU at a small size."""
    import torch

    import points2surf_tpu_torch  # noqa: F401  (TF32 off, fp32 numerics)

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        prebuild()
    ctx = harness.context(workload, seed, device, cfg)
    wl, cfg, spans = ctx.workload, ctx.cfg, ctx.spans
    driver = harness.traffic(wl["traffic"]).Traffic(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    card = harness.card(torch) if cuda else {"kind": device}
    if cuda:
        print(f"card: {card['kind']}, power limit {card['power_limit_w']} "
              f"W, SM clock {card['sm_clock_mhz']} of "
              f"{card['sm_clock_max_mhz']} MHz", flush=True)

    tracer = None
    if trace:
        from devtrace import DeviceTrace

        tracer = DeviceTrace(torch)
        tracer.start()
    t_open = time.perf_counter()
    result = driver.window(seconds)
    t_close = t_open + result["window_s"]
    events = tracer.stop() if tracer else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not forbidden_none():
        return None

    device_info = {"platform": "gpu" if cuda else device,
                   "kind": card["kind"], "count": 1,
                   "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if tracer:
        import devtrace

        red = devtrace.reduce(events, t_open, t_close, spans)
        device_info.update(busy_s=red["busy_s"], window_s=result["window_s"])
        breakdown = red["breakdown"]
        rctx = types.SimpleNamespace(
            cfg=cfg, workload=wl, counters=driver.counters, spans=spans,
            events=events, t_open=t_open, t_close=t_close,
            window_s=result["window_s"], busy_s=red["busy_s"])
        for m in cell_metrics(bench, workload, True):
            value = harness.reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result, setup_s=setup_s)
        for m in cell_metrics(bench, workload, False):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, checks = judge(driver.check(), wl["limits"])
    print(f"check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    # and again once the readers and the reference have run: what they
    # load is in this process too
    if not forbidden_none():
        return None
    work = int(result["work"])
    line = {"correct": bool(correct), "attempted": work,
            "failed": 0 if correct else work, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {kk: (None if isinstance(v, float) and math.isnan(v)
                               else v) for kk, v in c.items()}
                      for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    harness.cell(args.workload)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = drive(args.workload, args.seed, args.seconds, bool(args.trace))
    if line is None:
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
