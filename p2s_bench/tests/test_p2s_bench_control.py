"""The comparison that decides ``correct`` must fail what it exists to
catch. Each test skips the look for a card and drives the rest of a run on
the CPU at a small size with the cell's own limits: the control (the
reference computed in TF32 in the program's place) and, one by one, the
faults the cell can have, planted in the program underneath the timed
path."""

import pytest
import torch

import harness
import run
from conftest import tiny

SEED = 7


def _drive(cell, seconds=1.0):
    torch.set_num_threads(2)
    _, cfg = harness.cell(cell)
    return run.drive(cell, SEED, seconds, False, device="cpu",
                     cfg=tiny(cfg))


# the numbers the control is to fail, by traffic
CONTROL_FAILS = {"recon": ("dist_err",),
                 "train": ("loss_step1_err", "grad_median_err")}


@pytest.mark.parametrize("cell", ["p2s_vanilla.recon", "p2s_max.recon",
                                  "p2s_vanilla.train", "p2s_max.train"])
def test_control_is_not_correct(cell, monkeypatch):
    """TF32 in the reference, standing in the program's place, comes out
    as not correct through the run's own judgement at the workload's
    limits, and reads the numbers it is to fail at least 30 times what the
    program reads on the same seed (the sizes are the tests'; the readings
    at the cell's own size on the card are PERF.md's)."""
    wl, _ = harness.cell(cell)
    sound = _drive(cell)
    real = harness.traffic(wl["traffic"]).Traffic
    monkeypatch.setattr(real, "check",
                        lambda self, tf32=False, _c=real.check: _c(self, True))
    control = _drive(cell)
    assert sound["correct"]
    assert not control["correct"]
    for name in CONTROL_FAILS[wl["traffic"]]:
        got, ok = control["checks"][name], sound["checks"][name]
        assert got["value"] > got["limit"], name
        assert got["value"] >= 30 * ok["value"], name


@pytest.mark.parametrize("cell", ["p2s_vanilla.recon", "p2s_max.recon"])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """One distance of every query batch altered where it is produced."""
    from points2surf_tpu_torch.infer import query

    real = query.postprocess_sdf

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0] = out[0] * 0.5 + 0.01
        return out

    monkeypatch.setattr(query, "postprocess_sdf", altered)
    line = _drive(cell)
    assert not line["correct"]
    assert line["checks"]["dist_err"]["value"] > \
        line["checks"]["dist_err"]["limit"]


def test_altered_volume_is_not_correct(monkeypatch):
    """One voxel of the volume altered where it is produced."""
    from points2surf_tpu_torch.ops import voxel

    real = voxel.propagate_sign

    def altered(vol, *args, **kwargs):
        out = real(vol, *args, **kwargs).clone()
        out[1, 1, 1] = 0.5
        return out

    monkeypatch.setattr(voxel, "propagate_sign", altered)
    line = _drive("p2s_vanilla.recon", seconds=6.0)  # a whole visit
    assert line["checks"]["vol_diff"]["value"] >= 1
    assert not line["correct"]


@pytest.mark.parametrize("cell", ["p2s_vanilla.train", "p2s_max.train"])
def test_unchanged_state_is_not_correct(cell, monkeypatch):
    """A step that returns its state unchanged: no update."""
    from points2surf_tpu_torch.train.trainer import TrainStep

    monkeypatch.setattr(TrainStep, "update", lambda self: None)
    line = _drive(cell)
    assert not line["correct"]
    assert line["checks"]["delta_median_err"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["p2s_vanilla.train", "p2s_max.train"])
def test_half_batch_is_not_correct(cell, monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from points2surf_tpu_torch.models import losses

    real = losses.compute_loss

    def half(pred, batch, *args, **kwargs):
        rows = len(pred) // 2
        return real(pred[:rows], {k: v[:rows] for k, v in batch.items()},
                    *args, **kwargs)

    monkeypatch.setattr(losses, "compute_loss", half)
    line = _drive(cell)
    assert not line["correct"]


def test_sound_runs_are_correct():
    for cell in ("p2s_vanilla.recon", "p2s_vanilla.train"):
        assert _drive(cell)["correct"]
