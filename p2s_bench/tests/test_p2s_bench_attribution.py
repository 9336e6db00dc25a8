"""Attribution by launch on a synthetic trace: device seconds under the
innermost span open on the launching thread, idle seconds under the window
thread's innermost span with the writer threads' share, the clock tie and
its check, and the readings on empty inputs."""

import types

import pytest
from torch.autograd import DeviceType

import attribution
import devtrace
import harness
from conftest import tiny

MARK_HOST = 0.5
SHIFT = 9.5  # profiler time = perf_counter time + SHIFT
WINDOW, WRITER = 11, 22


def _span(sid, parent, name, tid, t0, t1):
    return {"id": sid, "parent": parent, "name": name, "tid": tid,
            "t0_ns": round(t0 * 1e9), "t1_ns": round(t1 * 1e9), "attrs": {}}


def _program():
    return {"spans": [
        _span(1, 0, "query.extract", WINDOW, 1.0, 1.3),
        _span(2, 1, "extract.certify", WINDOW, 1.2, 1.3),
        _span(3, 0, "query.forward", WINDOW, 1.3, 1.6),
        _span(4, 3, "kernel.chain", WINDOW, 1.35, 1.36),
        _span(5, 0, "write.off", WRITER, 1.1, 1.5),
    ], "counters": {"extract.tiled": 4, "extract.fallback": 1,
                    "write.bytes": 2_000_000, "host_syncs": 3}}


def _trace():
    """(ops, launches) on the profiler's clock: the marker, then ops
    launched in query.extract, kernel.chain, query.forward, one with no
    launch record, one from a thread that recorded no span, and one that
    starts before its launch."""
    s = SHIFT
    ops = [(devtrace.MARKER, 10.0, 10.001, 100),
           (devtrace.MARKER, 10.5, 10.501, 107),
           ("fill", 1.06 + s, 1.15 + s, 101),
           ("chain_pool_kernel", 1.4 + s, 1.7 + s, 102),
           ("add", 1.7 + s, 1.75 + s, 103),
           ("memset", 1.8 + s, 1.85 + s, 104),
           ("stray", 1.86 + s, 1.87 + s, 105),
           ("early", 1.88 + s, 1.89 + s, 106)]
    launches = {100: (WINDOW, 10.0), 107: (WINDOW, 10.49),
                101: (WINDOW, 1.05 + s), 102: (WINDOW, 1.355 + s),
                103: (WINDOW, 1.31 + s), 105: (99, 1.25 + s),
                106: (WINDOW, 1.9 + s)}
    return ops, launches


# host times just before and after each marker's launch
MARKS = [(MARK_HOST, None), (0.985, 0.995)]


def _attributed():
    ops, launches = _trace()
    offset, error, how = attribution.tie(ops, launches, MARKS)
    assert how == "launch" and offset == pytest.approx(-SHIFT)
    assert error == pytest.approx(0.005)
    return attribution.attribute(_program(), ops, launches, offset, 1.0, 2.0,
                                 WINDOW, {WINDOW: WINDOW})


def test_device_seconds_go_to_the_launching_threads_innermost_span():
    att = _attributed()
    assert att["self_s"] == pytest.approx({
        "query.extract": 0.09, "kernel.chain": 0.3, "query.forward": 0.05,
        "extract.certify": 0.01})  # the stray launch, put on the window
    assert att["incl_s"] == pytest.approx({
        "query.extract": 0.1, "kernel.chain": 0.3, "query.forward": 0.35,
        "extract.certify": 0.01})
    assert att["device_s"] == pytest.approx(0.09 + 0.3 + 0.05 + 0.05 + 0.01
                                            + 0.01)
    assert att["no_launch_s"] == pytest.approx(0.05)
    assert att["outside"] == pytest.approx({"memset": 0.05, "early": 0.01})
    assert att["stray_launches"] == 1
    assert att["early_ops"] == 1
    assert att["early_max_s"] == pytest.approx(0.02)
    assert att["retie_max_s"] == pytest.approx(0.02)
    assert att["early_left_ops"] == 0


def test_idle_gaps_go_to_the_window_threads_innermost_span():
    att = _attributed()
    assert att["idle_s"] == pytest.approx({
        "query.extract": 0.06 + 0.05, "extract.certify": 0.1,
        "query.forward": 0.05 + 0.04, "kernel.chain": 0.01,
        attribution.NONE: 0.05 + 0.01 + 0.01 + 0.11})
    # write.off is open on the writer thread over 1.1-1.5
    assert att["idle_writer_s"] == pytest.approx({
        "query.extract": 0.05, "extract.certify": 0.1,
        "query.forward": 0.09, "kernel.chain": 0.01,
        attribution.NONE: 0.0})
    assert att["idle_query_s"] == pytest.approx(0.31)
    assert att["idle_query_writer_s"] == pytest.approx(0.25)


def test_retie_moves_idle_gaps_not_the_launching_span():
    """An operation drawn 0.05 s before its launch is moved after it: the
    idle time around it follows, its span stays the launch's."""
    program = {"spans": [_span(1, 0, "query.extract", WINDOW, 0.0, 1.0),
                         _span(2, 0, "query.forward", WINDOW, 1.0, 2.0)],
               "counters": {}}
    ops = [("k", 0.45, 0.55, 1), ("k2", 1.2, 1.3, 2)]
    launches = {1: (WINDOW, 0.5), 2: (WINDOW, 0.6)}
    att = attribution.attribute(program, ops, launches, 0.0, 0.0, 2.0,
                                WINDOW, {WINDOW: WINDOW}, retie=10.0)
    assert att["early_ops"] == 1 and att["retie_max_s"] == pytest.approx(
        0.05)
    assert att["self_s"] == pytest.approx({"query.extract": 0.2})
    # busy 0.5-0.6 and 1.25-1.35 once shifted
    assert att["idle_s"] == pytest.approx({"query.extract": 0.9,
                                           "query.forward": 0.9})


def test_retie_follows_the_bins_wander_not_a_lone_lead():
    """Bin 0: 2000 operations 5 us after their launches and one 10 ms
    before its own (a wrong launch record): nothing shifts, the lone lead is
    left and counted. Bin 1: every operation 200 us before its launch (the
    device's clock wandering): the bin shifts by 200 us, no lead is left."""
    ops, launches = [], {}
    for i in range(2000):
        a = 0.1 + i * 1e-4
        ops.append(("k", a, a + 5e-5, i))
        launches[i] = (WINDOW, a - 5e-6)
    ops.append(("odd", 0.3, 0.30005, 5000))
    launches[5000] = (WINDOW, 0.31)
    for i in range(2000):
        a = 1.1 + i * 1e-4
        ops.append(("k", a, a + 5e-5, 10000 + i))
        launches[10000 + i] = (WINDOW, a + 2e-4)
    program = {"spans": [_span(1, 0, "train.backward", WINDOW, 0.0, 2.0)],
               "counters": {}}
    att = attribution.attribute(program, ops, launches, 0.0, 0.0, 2.0,
                                WINDOW, {WINDOW: WINDOW}, retie=1.0)
    assert att["early_ops"] == 2001
    assert att["early_max_s"] == pytest.approx(0.01)
    assert att["retie_max_s"] == pytest.approx(2e-4)
    assert att["early_left_ops"] == 1
    assert att["early_left_max_s"] == pytest.approx(0.01)
    raw = attribution.attribute(program, ops, launches, 0.0, 0.0, 2.0,
                                WINDOW, {WINDOW: WINDOW}, retie=None)
    assert raw["retie_max_s"] == 0.0 and raw["early_left_ops"] == 2001
    # the shift moves bin 1's busy time 200 us later, not its amount
    assert att["device_s"] == pytest.approx(raw["device_s"])
    assert sum(att["idle_s"].values()) == pytest.approx(
        sum(raw["idle_s"].values()))


def test_tie_falls_back_to_the_markers_start_on_the_device():
    ops, launches = _trace()
    del launches[100]
    offset, error, how = attribution.tie(ops, launches, MARKS)
    assert how == "device" and offset == pytest.approx(MARK_HOST - 10.0)


def test_records_split_device_operations_from_launch_calls():
    def event(name, device, start, dur, corr, tid=0):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: device,
            start_ns=lambda: start, duration_ns=lambda: dur,
            correlation_id=lambda: corr, start_thread_id=lambda: tid)

    raw = [event("k", DeviceType.CUDA, 2000, 500, 7),
           event("cudaLaunchKernel", DeviceType.CPU, 1500, 30, 7, 5),
           event("aten::add", DeviceType.CPU, 1000, 900, 0, 5)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    ops, launches = attribution.records(prof)
    assert len(ops) == 1 and ops[0][0] == "k" and ops[0][3] == 7
    assert ops[0][1:3] == pytest.approx((2e-6, 2.5e-6))
    assert launches == {7: (5, 1.5e-6)}


@pytest.mark.parametrize("order", [1, -1])
def test_records_take_the_runtime_call_of_a_shared_id(order):
    """One correlation id with a runtime and a driver call (either order of
    the profiler's events) is the runtime call's; with driver calls only,
    the one that starts last."""
    def event(name, device, start, corr, tid):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: device,
            start_ns=lambda: start, duration_ns=lambda: 10,
            correlation_id=lambda: corr, start_thread_id=lambda: tid)

    raw = [event("k", DeviceType.CUDA, 3000, 7, 0),
           event("cudaLaunchKernel", DeviceType.CPU, 1500, 7, 5),
           event("cuLaunchKernel", DeviceType.CPU, 1600, 7, 6),
           event("k2", DeviceType.CUDA, 3000, 8, 0),
           event("cuLaunchKernel", DeviceType.CPU, 1700, 8, 6),
           event("cuLaunchKernelEx", DeviceType.CPU, 1800, 8, 7)][::order]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    _, launches = attribution.records(prof)
    assert launches == {7: (5, 1.5e-6), 8: (7, 1.8e-6)}


def test_step_host_time_leaves_out_the_waits_inside_the_step():
    program = {"spans": [
        _span(1, 0, "train.extract", WINDOW, 0.0, 0.010),
        _span(2, 1, "extract.dense", WINDOW, 0.001, 0.009),
        _span(3, 2, attribution.WAIT, WINDOW, 0.002, 0.006),
        _span(4, 0, "train.forward", WINDOW, 0.010, 0.030),
        _span(5, 4, attribution.WAIT, WINDOW, 0.020, 0.028),
        _span(6, 0, "data.upload", WINDOW, 0.030, 0.040),
        _span(7, 6, attribution.WAIT, WINDOW, 0.031, 0.039)],
        "counters": {"host_syncs": 3}}
    assert attribution.host_s(program, "train.") == pytest.approx(0.018)
    got = attribution.readings({}, {"steps": 2}, program, None)
    assert got["step_host_ms.train"] == pytest.approx(9.0)
    assert attribution.waits(program) == {
        "extract.dense": (1, pytest.approx(0.004)),
        "train.forward": (1, pytest.approx(0.008)),
        "data.upload": (1, pytest.approx(0.008))}


def test_readings_from_the_synthetic_window():
    _, cfg = harness.cell("p2s_vanilla.recon")
    att = _attributed()
    got = attribution.readings(cfg, {"batches": 2, "batch_size": 2048},
                               _program(), att)
    assert got["extract_device_ms.recon"] == pytest.approx(100.0)
    assert got["cert_wait_ms.recon"] == pytest.approx(100.0)
    assert got["dense_fallback_share.recon"] == pytest.approx(25.0)
    assert got["sweep_idle_writer_share.recon"] == pytest.approx(
        100 * 0.25 / 0.31)
    assert got["write_mb_per_s.recon"] == pytest.approx(5.0)
    import costs

    assert got["chain_span_roofline.recon"] == pytest.approx(
        100 * costs.chain_cost(cfg, 2048)[1] * 2 / 0.3)


@pytest.mark.parametrize("cell", ["p2s_vanilla.recon", "p2s_max.train"])
def test_readings_are_none_on_empty_inputs(cell):
    _, cfg = harness.cell(cell)
    empty = {"spans": [], "counters": {}}
    counters = ({"batches": 0, "batch_size": 64} if "recon" in cell
                else {"steps": 0, "rows": []})
    got = attribution.readings(tiny(cfg), counters, empty, None)
    assert got and all(v is None for v in got.values()), got
    att = attribution.attribute(empty, [], {}, 0.0, 0.0, 1.0, WINDOW)
    assert att["device_s"] == 0.0 and att["idle_s"] == {attribution.NONE:
                                                        1.0}
    got = attribution.readings(tiny(cfg), counters, empty, att)
    assert all(v is None for v in got.values()), got


@pytest.mark.parametrize("cell,seconds", [("p2s_vanilla.recon", 6.0),
                                          ("p2s_max.train", 1.0)])
def test_a_cpu_window_reads_the_programs_spans(cell, seconds):
    """traced.py's window on the CPU at the tiny size, without the profile:
    the readings of host spans and counters read, the device ones do not.
    One thread: at the tiny size a shared CPU's threads only wait on each
    other, and the recon window must get through a visit to its writes."""
    import torch

    import traced

    _, cfg = harness.cell(cell)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = traced.traced(cell, 7, seconds, device="cpu", cfg=tiny(cfg))
    finally:
        torch.set_num_threads(threads)
    got = line["readings"]
    assert "host_syncs" not in line["counters"]  # nothing waits on the CPU
    if "recon" in cell:
        assert got["cert_wait_ms.recon"] > 0.0
        assert got["write_mb_per_s.recon"] > 0.0
        assert 0.0 <= got["dense_fallback_share.recon"] <= 100.0
        assert line["counters"]["volume.rounds"] >= 2
        device = ("extract_device_ms.recon", "chain_span_roofline.recon",
                  "sweep_idle_writer_share.recon")
    else:
        assert got["step_host_ms.train"] > 0.0
        assert line["spans"]["train.backward"][0] == \
            line["harness_counters"]["steps"]
        device = ("backward_device_ms.train", "tail_span_roofline.train")
    assert all(got[k] is None for k in device)

