"""The cell p2s_large_kNN.recon on the CPU at a small size whose patches
outnumber their sub-samples, as the configuration's do; its chain sites,
chain bound and model FLOPs; and the reader of select_share.recon on a
made-up trace."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import costs
import harness
import run
from conftest import tiny
from reference.model import P2S

CELL = "p2s_large_kNN.recon"
SEED = 2 ** 31 + 29


def _small() -> dict:
    """``tiny`` with 40-point patches over 32-point sub-samples (``tiny``
    gives 16 < 32)."""
    _, cfg = harness.cell(CELL)
    cfg = tiny(cfg)
    cfg["patch"].update(points_per_patch=40, sub_sample_size=32)
    return cfg


def test_cell_is_correct_and_its_control_is_not(monkeypatch):
    torch.set_num_threads(2)
    sound = run.drive(CELL, SEED, 1.0, False, device="cpu", cfg=_small())
    real = harness.traffic("recon").Traffic
    monkeypatch.setattr(real, "check",
                        lambda self, tf32=False, _c=real.check: _c(self, True))
    control = run.drive(CELL, SEED, 1.0, False, device="cpu", cfg=_small())
    assert sound["correct"], sound["checks"]
    assert not control["correct"]
    got, ok = control["checks"]["dist_err"], sound["checks"]["dist_err"]
    assert got["value"] > got["limit"]
    assert got["value"] >= 30 * ok["value"]


def test_chain_sites_and_bound():
    _, cfg = harness.cell(CELL)
    assert costs.chain_sites(cfg) == [(3, 1000), (64, 1000), (64, 1000),
                                      (64, 1200), (64, 1200)]
    assert costs.chain_cost(cfg, 2048)[1] * 1e3 == pytest.approx(19.12,
                                                                 abs=0.01)


def test_model_flop_counts_every_matmul():
    cfg = _small()
    model = P2S(cfg["model"]).eval()
    b = 3
    p, s = cfg["patch"]["points_per_patch"], cfg["patch"]["sub_sample_size"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.rand(b, p, 3), torch.rand(b, s, 3), torch.rand(b, 3))
    assert fc.get_total_flops() == pytest.approx(costs.model_flop(cfg) * b)


def _ctx(events, busy_s):
    return types.SimpleNamespace(events=events, busy_s=busy_s)


def test_select_share_reads_the_topk_kernels():
    """The selection's kernels and its sorts of float keys count, each
    once; the int-keyed sort of the Morton order, a long-keyed cub sort and
    the other ops do not."""
    reader = harness.reader("select_share.recon")
    topk = [
        "void at::native::mbtopk::computeBlockDigitCounts<float, unsigned "
        "int, unsigned int, 2>(...)",
        "void at::native::sbtopk::gatherTopK<float, unsigned int, 2>(...)",
        "void at::native::radixSortKVInPlace<2, -1, 64, 32, float, long, "
        "unsigned int>(...)",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<"
        "at_cuda_detail::cub::DeviceRadixSortPolicy<float, at::cuda::cub::"
        "detail::OpaqueType<8>, unsigned long long>::Policy900, ...>(...)",
    ]
    other = [
        "void at::native::radixSortKVInPlace<-2, -1, 64, 32, int, long, "
        "unsigned int>(...)",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<"
        "at_cuda_detail::cub::DeviceRadixSortPolicy<long, at::cuda::cub::"
        "detail::OpaqueType<8>, unsigned long long>::Policy900, ...>(...)",
        "void (anonymous namespace)::chain_pool_kernel<true, false, false>",
    ]
    events = [(n, 0.0, 0.125) for n in topk] + [(n, 0.5, 1.0)
                                                for n in other]
    assert reader.read(_ctx(events, 2.0)) == pytest.approx(25.0)
    assert reader.read(_ctx(events[len(topk):], 2.0)) is None
    assert reader.read(_ctx([], 0.0)) is None
