"""Run one cell's window with the port's recorder on, and attribute the
device's time to the port's own spans by launch:

    python3 p2s_bench/traced.py --workload <cell> --seed <n> --seconds <s>

Set-up is ``run.py``'s. Over the window the recorder
(``points2surf_tpu_torch.utils.trace``) is enabled and the device traced as
in ``run.py --trace 1``. No check follows the window. Prints one JSON line:
the cell's rate; ``readings`` (``attribution.readings``: the port's
per-layer readings); ``accepted`` (what the benchmark's accepted per-layer
readers read of the same window, for comparison), the clock tie,
``attribution`` (device seconds by span, idle seconds by label),
``idle_without_retie`` (the idle labels with the device's clock left as the
profiler gives it) and the launching threads; the spans' host seconds, the
host's waits for the card by the span around them, and the counters.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, the port

import attribution  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402

TOP = 12
TIE_MARKS = 4


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    return ap.parse_args(argv)


def _top(d: dict) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:TOP])


def traced(workload: str, seed: int, seconds: float, device: str = "cuda",
           cfg: dict | None = None) -> dict:
    """The result line of one window. ``device`` and ``cfg`` serve the
    tests, which run it on the CPU at a small size, where there is no
    device to trace."""
    import torch

    import points2surf_tpu_torch  # noqa: F401  (TF32 off, fp32 numerics)
    from points2surf_tpu_torch.utils import trace

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        run.prebuild()
    ctx = harness.context(workload, seed, device, cfg)
    driver = harness.traffic(ctx.workload["traffic"]).Traffic(ctx)
    if cuda:
        torch.cuda.synchronize()
    tracer = None
    if cuda:
        from devtrace import DeviceTrace

        tracer = DeviceTrace(torch)
        tracer.start()
        marks = [(tracer.mark_host, None)]
        for _ in range(TIE_MARKS):  # more markers, each timed both sides
            torch.cuda.synchronize()
            before = time.perf_counter()
            torch.cuda._sleep(1000)
            marks.append((before, time.perf_counter()))
        torch.cuda.synchronize()
    with trace.recording() as program:
        t_open = time.perf_counter()
        result = driver.window(seconds)
    t_close = t_open + result["window_s"]
    line = {"workload": workload, "seed": seed,
            "rate": result[driver.end_to_end],
            "window_s": result["window_s"]}
    att = None
    if tracer:
        import devtrace

        events = tracer.stop()
        ops, launches = attribution.records(tracer.prof)
        offset, error, how = attribution.tie(ops, launches, marks)
        window_tid = threading.get_native_id()
        # the markers were launched from the window's thread
        threads = {launches[o[3]][0]: window_tid for o in ops
                   if devtrace.MARKER in o[0] and o[3] in launches}
        att = attribution.attribute(program, ops, launches, offset, t_open,
                                    t_close, window_tid, threads)
        raw = attribution.attribute(program, ops, launches, offset, t_open,
                                    t_close, window_tid, threads, retie=None)
        red = devtrace.reduce(events, t_open, t_close, ctx.spans)
        rctx = types.SimpleNamespace(
            cfg=ctx.cfg, workload=ctx.workload, counters=driver.counters,
            spans=ctx.spans, events=events, t_open=t_open, t_close=t_close,
            window_s=result["window_s"], busy_s=red["busy_s"])
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        line["accepted"] = {
            m["name"]: harness.reader(m["name"]).read(rctx)
            for m in run.cell_metrics(bench, workload, True)}
        in_span = sum(att["self_s"].values())
        tids = collections.Counter(tid for tid, _ in launches.values())
        line.update(
            tie=how, offset_s=offset, tie_error_s=error,
            busy_s=red["busy_s"],
            harness_idle=dict(red["breakdown"]["idle_gaps"]),
            in_span_share=(in_span / att["device_s"] if att["device_s"]
                           else None),
            window_tid=window_tid,
            span_tids=sorted({s["tid"] for s in program["spans"]}),
            launch_tids=dict(tids.most_common(4)), threads=threads,
            attribution=dict(att, self_s=_top(att["self_s"]),
                             incl_s=_top(att["incl_s"]),
                             outside=_top(att["outside"])),
            idle_without_retie=_top(raw["idle_s"]))
    line["readings"] = attribution.readings(ctx.cfg, driver.counters,
                                            program, att)
    line["spans"] = attribution.span_stats(program)
    line["waits"] = attribution.waits(program)
    line["counters"] = program["counters"]
    line["harness_counters"] = {k: v for k, v in driver.counters.items()
                                if k != "rows"}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    line = traced(args.workload, args.seed, args.seconds)
    if not run.forbidden_none():  # says on standard error what is loaded
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
