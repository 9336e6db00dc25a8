"""The benchmark's tests: the harness's folder and the repository root on
the path, and the tiny configuration the CPU drives its cells at."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def tiny(cfg: dict) -> dict:
    """``cfg`` at a size the CPU runs in seconds: net 32, patches of 16
    points and sub-samples of 32, eval batch 64 at grid 32, train batch 24
    of 20 patches per shape."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["net_size"] = 32
    cfg["patch"].update(points_per_patch=16, sub_sample_size=32)
    cfg["train"].update(batch_size=24, patches_per_shape=20)
    cfg["eval"].update(batch_size=64, grid_resolution=32)
    return cfg


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    """Each test's outputs under its own temporary directory."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
