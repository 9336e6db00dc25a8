"""BENCHMARK.json against the contract's limits, and every cell's files
found by name: its configuration, traffic driver, limits and readers."""

import json
import re

import pytest

import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["p2s_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_fits_the_day():
    # a full check with 24 cells: 2 + 14 * 24 runs of run_seconds + 60 s,
    # 2 * 90 s of compiling per cell, 1200 s spare
    total = ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_their_cells_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        assert harness.reader(m["name"]).read  # a reader of its own
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl, cfg = harness.cell(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"] and wl["why"] == entry["why"]
    assert entry["chips"] == 1
    conf = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert conf["file"] == f"p2s_bench/configs/{cfg['name']}.json"
    assert conf["reduced"] == cfg["reduced"] == []
    driver = harness.traffic(wl["traffic"]).Traffic
    assert set(wl["limits"]) == set(driver.checks)
    reports = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
    assert {m["name"] for m in reports} == {"setup_s", driver.end_to_end}
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
