"""What every run of the benchmark shares: finding a cell's files by name,
the harness's spans, the card's description, the benchmark's weights in the
program's model, and the check that no JAX module was loaded."""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "points2surf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the file ``path`` as a module of its own (names with dots,
    such as a per-layer metric's, are fine), once per process."""
    name = "p2s_bench_" + path.stem.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str) -> tuple[dict, dict]:
    """(the workload file, its configuration file) of the cell ``workload``."""
    wl = load_json(HERE / "workloads" / f"{workload}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def traffic(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py")


def reader(metric: str):
    return load_module(HERE / "layer_metrics" / f"{metric}.py")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Spans:
    """Host-clock spans around the harness's calls into the program: (name,
    start, end) in ``time.perf_counter`` seconds, kept in memory."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self._index: tuple = ([], [], 0.0)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def total(self, *names: str, since: float = float("-inf")) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records
                   if n in names and t0 >= since)

    def at(self, t: float) -> str | None:
        """The latest-started span open at host time ``t``."""
        if len(self._index[0]) != len(self.records):
            recs = sorted(self.records, key=lambda r: r[1])
            longest = max((r[2] - r[1] for r in recs), default=0.0)
            self._index = ([r[1] for r in recs], recs, longest)
        starts, recs, longest = self._index
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t - recs[i][1] <= longest:
            if t < recs[i][2]:
                return recs[i][0]
            i -= 1
        return None


def card(torch) -> dict:
    """The card's name as torch reports it, and nvidia-smi's power limit and
    SM clock (null where nvidia-smi cannot be read)."""
    info = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None,
            "sm_clock_mhz": None, "sm_clock_max_mhz": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        fields = [f.strip() for f in out.splitlines()[0].split(",")]
        for key, value in zip(("power_limit_w", "sm_clock_mhz",
                               "sm_clock_max_mhz"), fields[1:]):
            info[key] = float(value)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def load_weights(model, weights: dict) -> None:
    """Load the benchmark's weights (``reference.model.seeded_weights``) into
    the program's ``model``: every name must match, shape for shape."""
    own = model.state_dict()
    if set(own) != set(weights):
        raise KeyError(f"the program's model and the reference differ in "
                       f"{sorted(set(own) ^ set(weights))[:8]}")
    model.load_state_dict(weights, strict=True)


def context(workload: str, seed: int, device: str, cfg: dict | None = None):
    """What a traffic driver is built from: the cell's workload file, its
    configuration (or ``cfg``), the seed, the device, the spans, the
    repository root and the run's output directory."""
    wl, own = cell(workload)
    return types.SimpleNamespace(
        cfg=cfg or own, workload=wl, seed=seed, device=device,
        spans=Spans(), root=ROOT, out=out_dir(workload),
        load_weights=load_weights)


def out_dir(workload: str) -> Path:
    """The run's scratch directory for outputs, under ``TMPDIR`` (made
    anew; a shape's files are overwritten by its next visit)."""
    d = Path(tempfile.gettempdir()) / "p2s_bench" / workload
    d.mkdir(parents=True, exist_ok=True)
    return d
