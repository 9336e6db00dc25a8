"""On the card: a short run of each training cell and of a reconstruction
cell through the whole harness, correct by the cell's limits."""

import pytest

import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("p2s_vanilla.train", 3.0),
                                          ("p2s_max.recon", 3.0)])
def test_short_run_on_the_card_is_correct(cell, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = run.drive(cell, 2 ** 31 + 101, seconds, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0.0
    assert line["metrics"]
