"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level module name, and the reference loads nothing of the port.
Each check runs in a fresh interpreter (the suite itself imports JAX)."""

import subprocess
import sys
import types

import harness
import run
from conftest import tiny

DRIVE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
import harness, run
from conftest import tiny
for cell in ("p2s_vanilla.recon", "p2s_max.train"):
    _, cfg = harness.cell(cell)
    run.drive(cell, 7, 0.5, False, device="cpu", cfg=tiny(cfg))
for path in sorted((harness.HERE / "layer_metrics").glob("*.py")):
    harness.load_module(path)
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path[:0] = [{bench!r}]
import reference.model, reference.data, reference.volume, reference.train
import costs
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def _tops(code: str) -> set:
    src = code.format(bench=str(harness.HERE), root=str(harness.ROOT),
                      tests=str(harness.HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _tops(DRIVE)
    assert "points2surf_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert not tops & (set(harness.FORBIDDEN) | {"points2surf_tpu_torch"})


def test_forbidden_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_module", sys)
    monkeypatch.setitem(sys.modules, "points2surf_tpu_torch_x", sys)
    found = harness.forbidden_loaded()
    assert "jaxlike_module" not in found
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_loaded()


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness, a run
    fails before it prints a result (here at the look for a card, or, on a
    machine with one, at the import of the port)."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "p2s_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "p2s_bench/run.py", "--workload",
         "p2s_vanilla.train", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_a_module_loaded_after_the_window_gives_no_result(monkeypatch,
                                                          capsys):
    """A module of JAX that the reference (or a reader) loads once the
    window has closed still stops the result line."""
    import torch

    torch.set_num_threads(2)
    cell = "p2s_vanilla.train"
    _, cfg = harness.cell(cell)
    traffic = harness.traffic("train").Traffic

    def check(self, tf32=False, _real=traffic.check):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return _real(self, tf32)

    monkeypatch.setattr(traffic, "check", check)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    drive = run.drive
    monkeypatch.setattr(run, "drive", lambda w, s, sec, tr: drive(
        w, s, sec, tr, device="cpu", cfg=tiny(cfg)))
    rc = run.main(["--workload", cell, "--seed", "3", "--seconds", "0.5"])
    out = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out.out
    assert "jax" in out.err
