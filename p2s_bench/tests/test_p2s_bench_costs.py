"""costs.py against hand counts at small shapes, against chip_smoke's cost
functions at the call sites of PERF.md's kernel table, and the model's FLOP
count against torch's FLOP counter on the reference model."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
import costs
import harness
from conftest import tiny
from reference.model import P2S


def test_hand_counts():
    # one point, cin 3, cout 8: 3*64 + 64*128 + 128*8 MACs
    assert costs.fused_cost(1, 1, 3, 8)[0] == 2 * (192 + 8192 + 1024)
    # bytes: x 3, W 192 + 8192 + 1024, affines 2 * (64 + 128 + 8), out 8
    assert costs.fused_cost(1, 1, 3, 8)[1] == 4 * (3 + 9408 + 400 + 8)
    assert costs.pooled_tail_cost(2, 3, 4) == (
        2 * 2 * 3 * 128 * 4, 4 * (2 * 3 * 128 + 512 + 4 + 6 * 2 * 4))
    assert costs.bound_s(165e12, 0.0) == pytest.approx(1.0)
    assert costs.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("b", [64, 4096])
@pytest.mark.parametrize("cin,n", [(3, 1300), (64, 1000), (64, 300)])
def test_against_chip_smoke(b, cin, n):
    assert costs.head_cost(b, n, cin) == chip_smoke._head_cost(b, n, cin)
    assert costs.tail_cost(b, n, 1024) == chip_smoke._tail_cost(b, n)
    assert costs.fused_cost(b, n, cin, 1024) == chip_smoke._fused_cost(
        b, n, cin)
    assert costs.pooled_tail_cost(b, n, 1024) == \
        chip_smoke._pooled_tail_cost(b, n)


def test_chain_sites():
    _, vanilla = harness.cell("p2s_vanilla.recon")
    _, mx = harness.cell("p2s_max.recon")
    assert costs.chain_sites(vanilla) == [(3, 1300), (64, 1000), (64, 1000),
                                          (64, 300), (64, 300)]
    assert costs.chain_sites(mx) == [(64, 1000), (64, 1000), (64, 300),
                                     (64, 300)]
    # the five chains of a batch of 4096 at least 27.6 ms (PERF.md's bound
    # of the split pair, h2 through memory: 28.65 ms)
    assert costs.chain_cost(vanilla, 4096)[1] * 1e3 == pytest.approx(
        27.6, abs=0.1)


@pytest.mark.parametrize("cell", ["p2s_vanilla.recon", "p2s_max.recon"])
def test_model_flop_counts_every_matmul(cell):
    _, cfg = harness.cell(cell)
    cfg = tiny(cfg)
    model = P2S(cfg["model"]).eval()
    b = 3
    p, s = cfg["patch"]["points_per_patch"], cfg["patch"]["sub_sample_size"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.rand(b, p, 3), torch.rand(b, s, 3), torch.rand(b, 3))
    assert fc.get_total_flops() == pytest.approx(costs.model_flop(cfg) * b)
