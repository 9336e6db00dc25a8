"""Device time attributed to the port's own spans by launch.

The port records spans and counters (``points2surf_tpu_torch.utils.trace``:
each span's id, parent, name, native thread id and start and end on
``time.perf_counter_ns``). The profiler of a traced window records each
device operation with the correlation id of the runtime call that launched
it, and each such call's host thread and time. This module ties the two
clocks and puts every device operation under the innermost span that was
open on its launching thread when it was launched, and every idle gap of the
device under the innermost span open on the window's thread.

The clocks are tied by the marker (``devtrace.MARKER``): its launch record's
host time on the profiler's clock is the ``perf_counter`` time the harness
noted just before launching it.
"""

from __future__ import annotations

import bisect

import numpy as np

import devtrace

WRITE = "write."
WAIT = "sync.wait"
RETIE_S = 0.25
RETIE_Q = 0.999
QUERY = "query."
NONE = "(no span)"


def records(prof) -> tuple[list, dict]:
    """(device operations, launch records) of a ``torch.profiler`` run:
    operations as (name, start, end, correlation id) and launches as
    {correlation id: (thread id, host start)}, in seconds on the profiler's
    clock. The thread id is the profiler's own numbering of threads.

    The launch record of an id is its CUDA runtime call (``cuda*``) where
    there is one, else its driver call (``cu*``); of several of a kind, the
    one that starts last."""
    from torch.autograd import DeviceType

    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        start = e.start_ns() / 1e9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            ops.append((name, start, start + e.duration_ns() / 1e9, corr))
        elif corr and name.startswith("cu"):
            key = (name.startswith("cuda"), start)
            if corr not in calls or key > calls[corr][0]:
                calls[corr] = (key, (e.start_thread_id(), start))
    return ops, {corr: call for corr, (_, call) in calls.items()}


def tie(ops, launches, marks) -> tuple[float, float, str]:
    """(offset, error, how): ``perf_counter`` time = profiler time + offset,
    within ``error`` seconds. ``marks`` holds (host time just before, host
    time just after, or None) of each marker launched, in order; the
    device's marker operations are taken in the same order. Each marker's
    launch record started between its two host times, so the offset lies
    in every such interval: their intersection is taken. Without launch
    records the markers' starts on the device stand in (``how`` says
    which), as ``devtrace`` ties the clocks."""
    marker_ops = sorted((o for o in ops if devtrace.MARKER in o[0]),
                        key=lambda o: o[1])
    if not marker_ops:
        raise ValueError("the trace holds no marker")
    pairs = list(zip(marker_ops, marks))
    how = "launch" if all(o[3] in launches for o, _ in pairs) else "device"

    def at(o):
        return launches[o[3]][1] if how == "launch" else o[1]

    lo = max(before - at(o) for o, (before, _) in pairs)
    his = [after - at(o) for o, (_, after) in pairs if after is not None]
    return lo, (min(his) - lo if his else float("inf")), how


class Timeline:
    """The innermost span open on one thread, over time."""

    def __init__(self, spans):
        edges = []
        for s in spans:
            if s["t1_ns"] <= s["t0_ns"]:
                continue  # no time of its own
            edges.append((s["t0_ns"] / 1e9, 1, s["id"]))
            edges.append((s["t1_ns"] / 1e9, 0, s["id"]))
        edges.sort()  # at a tie an end goes before a start
        self.starts, self.ids = [], []
        stack = []
        for t, kind, sid in edges:
            if kind:
                stack.append(sid)
            elif sid in stack:
                stack.remove(sid)
            top = stack[-1] if stack else 0
            if self.starts and self.starts[-1] == t:
                self.ids[-1] = top
            else:
                self.starts.append(t)
                self.ids.append(top)

    def at(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.ids[i] if i >= 0 else 0

    def pieces(self, a: float, b: float):
        """(start, end, span id) covering [a, b]."""
        i = bisect.bisect_right(self.starts, a) - 1
        t = a
        while t < b:
            nxt = (self.starts[i + 1] if i + 1 < len(self.starts)
                   else float("inf"))
            end = min(b, nxt)
            yield t, end, self.ids[i] if i >= 0 else 0
            t, i = end, i + 1


class Union:
    """The union of intervals, and its overlap with [a, b]."""

    def __init__(self, intervals):
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]

    def overlap(self, a: float, b: float) -> float:
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        got = 0.0
        while i < len(self.starts) and self.starts[i] < b:
            got += max(0.0, min(b, self.ends[i]) - max(a, self.starts[i]))
            i += 1
        return got


def attribute(program: dict, ops, launches, offset: float, t_open: float,
              t_close: float, window_tid: int, threads: dict | None = None,
              retie: float | None = RETIE_S) -> dict:
    """Device seconds by span and idle seconds by label, in the window.

    ``program`` is what the recorder's ``take()`` returned; ``ops`` and
    ``launches`` what :func:`records` returned; ``offset`` from
    :func:`tie`; ``t_open``/``t_close`` the window on ``perf_counter``;
    ``window_tid`` the native id of the window's thread; ``threads`` maps
    the profiler's thread ids to native ones. A launch from a thread not in
    ``threads`` counts in ``stray_launches`` and is put on the window's
    thread.

    The profiler's device timestamps wander from its host timestamps over a
    long window, by up to some hundred microseconds for seconds at a time
    (operations that start before their own launch). Per ``retie`` seconds
    of the device's clock the operations are shifted later by the
    ``RETIE_Q`` quantile of their leads over their launches (where that is
    positive), so that a lone operation tied to a wrong launch record does
    not move the rest of its bin; ``retie=None`` shifts nothing.
    ``early_ops`` and ``early_max_s`` count the leads before the shift,
    ``early_left_ops`` and ``early_left_max_s`` those left after it,
    ``retie_max_s`` is the largest shift. The shift moves the device's busy
    and idle intervals only: an operation is put under a span by its
    launch's host time.

    Returns ``self_s`` and ``incl_s`` (device seconds of the operations
    launched under each span name, innermost only or with every enclosing
    span), ``device_s`` (every operation's seconds in the window),
    ``no_launch_s``, ``outside`` (operations under no span, by name),
    ``idle_s`` and ``idle_writer_s`` (idle seconds by the innermost span on
    the window's thread, and of those the seconds in which a ``write.*``
    span was open on another thread), ``idle_query_s`` and
    ``idle_query_writer_s`` (the same over the idle time while a ``query.*``
    span was open on the window's thread), the leads, ``retie_max_s`` and
    ``stray_launches``."""
    threads = threads or {}
    spans = {s["id"]: s for s in program["spans"]}
    by_tid: dict[int, list] = {}
    for s in program["spans"]:
        by_tid.setdefault(s["tid"], []).append(s)
    lines = {tid: Timeline(ss) for tid, ss in by_tid.items()}
    window = lines.get(window_tid) or Timeline([])

    def chain(sid):
        names = []
        while sid:
            s = spans[sid]
            if s["name"] not in names:
                names.append(s["name"])
            sid = s["parent"]
        return names

    by_bin: dict[int, list] = {}
    for name, a, _, corr in ops:
        call = launches.get(corr)
        if call is not None and devtrace.MARKER not in name:
            by_bin.setdefault(int(a // (retie or 1.0)), []).append(
                call[1] - a)
    leads = [x for b in by_bin.values() for x in b if x > 0]
    shift = {}
    if retie:
        for k, b in by_bin.items():
            q = float(np.quantile(b, RETIE_Q, method="higher"))
            if q > 0:
                shift[k] = q
    left = [x - shift.get(k, 0.0) for k, b in by_bin.items() for x in b
            if x > shift.get(k, 0.0)]

    chains: dict[int, list] = {}
    self_s: dict[str, float] = {}
    incl_s: dict[str, float] = {}
    outside: dict[str, float] = {}
    device_s = no_launch_s = 0.0
    stray = 0
    window_ops = []
    for name, a, b, corr in ops:
        if devtrace.MARKER in name:
            continue
        late = offset + shift.get(int(a // (retie or 1.0)), 0.0)
        a, b = a + late, b + late
        lo, hi = max(a, t_open), min(b, t_close)
        if hi <= lo:
            continue
        window_ops.append((name, a, b))
        dur = hi - lo
        device_s += dur
        call = launches.get(corr)
        if call is None:
            no_launch_s += dur
            outside[name] = outside.get(name, 0.0) + dur
            continue
        tid, t_launch = call[0], call[1] + offset
        if tid not in threads:
            stray += 1
        line = lines.get(threads.get(tid, window_tid), window)
        sid = line.at(t_launch)
        names = chains.get(sid) if sid else []
        if names is None:
            names = chains[sid] = chain(sid)
        if not names:
            outside[name] = outside.get(name, 0.0) + dur
            continue
        self_s[names[0]] = self_s.get(names[0], 0.0) + dur
        for n in names:
            incl_s[n] = incl_s.get(n, 0.0) + dur

    writers = Union([(s["t0_ns"] / 1e9, s["t1_ns"] / 1e9)
                     for s in program["spans"]
                     if s["tid"] != window_tid
                     and s["name"].startswith(WRITE)])
    idle: dict[str, float] = {}
    idle_writer: dict[str, float] = {}
    idle_query = idle_query_writer = 0.0
    edge = t_open
    busy = devtrace.busy_intervals(window_ops, t_open, t_close)
    for a, b in busy + [(t_close, t_close)]:
        if a > edge:
            for p0, p1, sid in window.pieces(edge, a):
                names = chains.get(sid) if sid else []
                if names is None:
                    names = chains[sid] = chain(sid)
                label = names[0] if names else NONE
                w = writers.overlap(p0, p1)
                idle[label] = idle.get(label, 0.0) + (p1 - p0)
                idle_writer[label] = idle_writer.get(label, 0.0) + w
                if any(n.startswith(QUERY) for n in names):
                    idle_query += p1 - p0
                    idle_query_writer += w
        edge = max(edge, b)
    return {"self_s": self_s, "incl_s": incl_s, "device_s": device_s,
            "no_launch_s": no_launch_s, "outside": outside,
            "idle_s": idle, "idle_writer_s": idle_writer,
            "idle_query_s": idle_query,
            "idle_query_writer_s": idle_query_writer,
            "early_ops": len(leads), "early_max_s": max(leads, default=0.0),
            "early_left_ops": len(left),
            "early_left_max_s": max(left, default=0.0),
            "retie_max_s": max(shift.values(), default=0.0),
            "stray_launches": stray}


def span_stats(program: dict) -> dict:
    """{name: (count, host seconds)} of the recorded spans."""
    out: dict[str, list] = {}
    for s in program["spans"]:
        c = out.setdefault(s["name"], [0, 0.0])
        c[0] += 1
        c[1] += (s["t1_ns"] - s["t0_ns"]) / 1e9
    return {k: tuple(v) for k, v in out.items()}


def host_s(program: dict, prefix: str) -> float:
    """Host seconds in the spans whose names start with ``prefix``, less the
    ``sync.wait`` spans inside them: the host's own time there, without its
    waits for the card."""
    spans = {s["id"]: s for s in program["spans"]}

    def inside(s):
        sid = s["parent"]
        while sid in spans:
            if spans[sid]["name"].startswith(prefix):
                return True
            sid = spans[sid]["parent"]
        return False

    got = 0
    for s in program["spans"]:
        if s["name"].startswith(prefix):
            got += s["t1_ns"] - s["t0_ns"]
        elif s["name"] == WAIT and inside(s):
            got -= s["t1_ns"] - s["t0_ns"]
    return got / 1e9


def waits(program: dict) -> dict:
    """{name: (count, host seconds)} of the ``sync.wait`` spans, by the name
    of the span around each."""
    names = {s["id"]: s["name"] for s in program["spans"]}
    out: dict[str, list] = {}
    for s in program["spans"]:
        if s["name"] == WAIT:
            c = out.setdefault(names.get(s["parent"], NONE), [0, 0.0])
            c[0] += 1
            c[1] += (s["t1_ns"] - s["t0_ns"]) / 1e9
    return {k: tuple(v) for k, v in out.items()}


def readings(cfg: dict, counters: dict, program: dict, att: dict | None
             ) -> dict:
    """The per-layer readings of the port's spans and counters over a
    window, from the harness's ``counters`` (recon's or train's) and the
    attribution ``att`` (None without a device trace); each reading is None
    where the window holds nothing to read, as a program without the
    recorder gives."""
    import costs

    st = span_stats(program)
    pc = program["counters"]
    incl = att["incl_s"] if att else {}
    out = {}
    if "batches" in counters:  # recon
        batches = counters["batches"]
        n = st.get("query.extract", (0, 0.0))[0]
        extract_s = incl.get("query.extract", 0.0)
        certify_s = st.get("extract.certify", (0, 0.0))[1]
        chain_s = incl.get("kernel.chain", 0.0)
        write_s = sum(v[1] for k, v in st.items() if k.startswith(WRITE))
        out["extract_device_ms.recon"] = (1e3 * extract_s / n
                                          if n and extract_s else None)
        out["cert_wait_ms.recon"] = (1e3 * certify_s / n
                                     if n and certify_s else None)
        out["dense_fallback_share.recon"] = (
            100.0 * pc.get("extract.fallback", 0) / pc["extract.tiled"]
            if pc.get("extract.tiled") else None)
        out["chain_span_roofline.recon"] = (
            100.0 * costs.chain_cost(cfg, counters["batch_size"])[1]
            * batches / chain_s if chain_s and batches else None)
        out["sweep_idle_writer_share.recon"] = (
            100.0 * att["idle_query_writer_s"] / att["idle_query_s"]
            if att and att["idle_query_s"] else None)
        out["write_mb_per_s.recon"] = (
            pc["write.bytes"] / 1e6 / write_s
            if write_s and pc.get("write.bytes") else None)
    if "steps" in counters:  # train
        steps = counters["steps"]
        step_s = host_s(program, "train.")
        backward_s = incl.get("train.backward", 0.0)
        tail_s = incl.get("kernel.tail", 0.0)
        rows = counters.get("rows", [])
        out["step_host_ms.train"] = (1e3 * step_s / steps
                                     if step_s and steps else None)
        out["backward_device_ms.train"] = (1e3 * backward_s / steps
                                           if backward_s and steps else None)
        out["tail_span_roofline.train"] = (
            100.0 * sum(costs.tail_cost_step(cfg, b)[1] for b in rows)
            / tail_s if tail_s and rows else None)
    return out
