"""The cell p2s_small_radius.recon: its files resolve to the upstream's
fixed-radius experiment and a ball-mode traffic module; on the CPU at a small
size it is correct and its TF32 control is not; its chain sites; and
``reference/ball.py`` loads nothing of the port (the import test names the
reference modules one by one, so this one is held here)."""

import subprocess
import sys

import pytest
import torch

import costs
import harness
import run
from conftest import tiny

CELL = "p2s_small_radius.recon"
SEED = 2 ** 31 + 31


def test_cell_files_resolve():
    wl, cfg = harness.cell(CELL)
    assert (wl["config"], wl["traffic"]) == ("p2s_small_radius",
                                            "recon_ball")
    assert cfg["source"].endswith("/experiments/train_p2s_small_radius.sh")
    assert cfg["eval_source"].endswith(
        "/experiments/eval_p2s_small_radius.sh")
    p, m = cfg["patch"], cfg["model"]
    assert (p["patch_radius"], p["points_per_patch"],
            p["sub_sample_size"], p["uniform_subsample"]) == (0.05, 300,
                                                              1000, False)
    assert (m["use_point_stn"], m["shared_transformation"],
            m["single_transformer"], m["net_size"]) == (True, False, False,
                                                        1024)
    assert cfg["train"]["batch_size"] == 701 and cfg["reduced"] == []
    ev = cfg["eval"]
    assert (ev["batch_size"], ev["grid_resolution"], ev["epsilon"],
            ev["certainty_threshold"], ev["sigma"]) == (2048, 256, 3, 13, 5)
    ball = harness.traffic("recon_ball").Traffic
    recon = harness.traffic("recon").Traffic
    assert issubclass(ball, recon) and ball.checks == recon.checks
    assert set(wl["limits"]) == set(ball.checks)
    assert wl["limits"]["grid_diff"] == wl["limits"]["vol_diff"] == 0


def test_cell_is_correct_and_its_control_is_not(monkeypatch):
    torch.set_num_threads(2)
    _, cfg = harness.cell(CELL)
    sound = run.drive(CELL, SEED, 1.0, False, device="cpu", cfg=tiny(cfg))
    real = harness.traffic("recon_ball").Traffic
    monkeypatch.setattr(real, "check",
                        lambda self, tf32=False, _c=real.check: _c(self, True))
    control = run.drive(CELL, SEED, 1.0, False, device="cpu", cfg=tiny(cfg))
    assert sound["correct"], sound["checks"]
    assert not control["correct"]
    got, ok = control["checks"]["dist_err"], sound["checks"]["dist_err"]
    assert got["value"] > got["limit"]
    assert got["value"] >= 30 * ok["value"]


def test_chain_sites():
    _, cfg = harness.cell(CELL)
    assert costs.chain_sites(cfg) == [(3, 1000), (64, 1000), (64, 1000),
                                      (64, 300), (64, 300)]
    assert costs.chain_cost(cfg, 2048)[1] * 1e3 == pytest.approx(12.71,
                                                                 abs=0.01)


def test_the_ball_reference_loads_nothing_of_the_program():
    code = (f"import sys\nsys.path[:0] = [{str(harness.HERE)!r}]\n"
            "import reference.ball\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & (set(harness.FORBIDDEN) | {"points2surf_tpu_torch"})
