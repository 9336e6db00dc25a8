"""The yardstick's arithmetic: operations and bytes of the port's kernels and
of the whole model, counted from shapes, and the card's peaks.

The chain and tail counts are frozen copies of ``chip_smoke.py``'s
``_head_cost``, ``_tail_cost``, ``_fused_cost`` and ``_pooled_tail_cost``
(``chip_smoke.py:389-420`` at the commit that added this benchmark), with
the width ``cout`` passed in instead of read from a module constant. They
stay here, unchanged by later work on the program, so that a roofline share
measured today and one measured after a change divide by the same numbers.

A share is never clipped: one above 100% means the operations or bytes are
counted too high or the time leaves out part of the work.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W): the
# fp32 class of the port's kernels is 3xTF32, so its peak is a third of the
# 495 TFLOP/s TF32 rate, as PERF.md's kernel table has used since the port
# began; bf16 operands at 989 TFLOP/s; HBM3 at 3.35 TB/s. A card set below
# 700 W runs slower; every run prints its power limit beside these.
PEAK_FLOPS_FP32 = 495e12 / 3
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12

# the widths the chain and tail kernels compute (conv1 / conv2 of a trunk)
C1, C2 = 64, 128


def bound_s(flop: float, nbytes: float, peak: float = PEAK_FLOPS_FP32):
    """Least seconds the card could take: the larger of the operations at
    ``peak`` and the bytes at ``PEAK_BYTES``."""
    return max(flop / peak, nbytes / PEAK_BYTES)


def head_cost(b, n, cin, h2_bytes=4):
    """(FLOP, bytes) of chain_head: layers 1-2 of b * n points."""
    flop = 2.0 * b * n * (cin * C1 + C1 * C2)
    nbytes = (4.0 * (b * n * cin + cin * C1 + C1 * C2 + 2 * (C1 + C2))
              + h2_bytes * b * n * C2)
    return flop, nbytes


def tail_cost(b, n, cout, h2_bytes=4):
    """(FLOP, bytes) of the layer-3 kernel: 128 -> cout and the pool."""
    flop = 2.0 * b * n * C2 * cout
    nbytes = h2_bytes * b * n * C2 + 4.0 * (C2 * cout + 2 * cout + b * cout)
    return flop, nbytes


def fused_cost(b, n, cin, cout):
    """(FLOP, bytes) of one whole chain (layers 1-3 and the pool): x read
    once in fp32, the weights and affines, the pooled (b, cout) written."""
    flop = 2.0 * b * n * (cin * C1 + C1 * C2 + C2 * cout)
    nbytes = 4.0 * (b * n * cin + cin * C1 + C1 * C2 + C2 * cout
                    + 2 * (C1 + C2 + cout) + b * cout)
    return flop, nbytes


def pooled_tail_cost(b, n, cout):
    """(FLOP, bytes) of pooled_tail: 128 -> cout and six (b, cout) outputs."""
    flop = 2.0 * b * n * C2 * cout
    nbytes = 4.0 * (b * n * C2 + C2 * cout + cout + 6 * b * cout)
    return flop, nbytes


def chain_sites(cfg: dict) -> list[tuple[int, int]]:
    """(cin, points) of every three-layer chain of one forward of the
    configuration ``cfg`` (a ``configs/*.json``): each transformer trunk and
    each encoder tail. The same sites are the eval chains and the train
    tails (the tails' layer 3 runs 128 -> net)."""
    m, p = cfg["model"], cfg["patch"]
    if m["single_transformer"]:
        raise ValueError("single_transformer is not counted")
    n_patch, n_sub = p["points_per_patch"], p["sub_sample_size"]
    sites = []
    if m["use_point_stn"] and m["shared_transformation"]:
        sites.append((3, n_patch + n_sub))
    for n, point_stn in ((n_sub, m["use_point_stn"]
                          and not m["shared_transformation"]),
                         (n_patch, False)):
        if point_stn:
            sites.append((3, n))
        if m["use_feat_stn"]:
            sites.append((C1, n))
        sites.append((C1, n))
    return sites


def chain_cost(cfg: dict, b: int):
    """(FLOP, least seconds) of every eval chain of one forward of ``b``
    queries, each chain bounded on its own."""
    net = cfg["model"]["net_size"]
    flop = secs = 0.0
    for cin, n in chain_sites(cfg):
        f, nb = fused_cost(b, n, cin, net)
        flop += f
        secs += bound_s(f, nb)
    return flop, secs


def tail_cost_step(cfg: dict, b: int):
    """(FLOP, least seconds) of the train tails of one step of ``b`` rows:
    one ``pooled_tail`` per chain site."""
    net = cfg["model"]["net_size"]
    flop = secs = 0.0
    for _, n in chain_sites(cfg):
        f, nb = pooled_tail_cost(b, n, net)
        flop += f
        secs += bound_s(f, nb)
    return flop, secs


def _trunk_flop(cin: int, n: int, net: int, out: int) -> float:
    """A transformer: conv cin -> 64 -> 128 -> net on n points, then fc
    net -> net/2 -> net/4 -> out."""
    return 2.0 * (n * (cin * C1 + C1 * C2 + C2 * net)
                  + net * (net // 2) + (net // 2) * (net // 4)
                  + (net // 4) * out)


def model_flop(cfg: dict) -> float:
    """Matmul FLOPs of one forward of one query of the configuration: every
    conv and fc layer of both encoders, the transformers, the point and
    feature transforms and the head. BatchNorm, relu, the pools and the
    post-processing are elementwise and not counted."""
    m, p = cfg["model"], cfg["patch"]
    if m["single_transformer"]:
        raise ValueError("single_transformer is not counted")
    net, out = m["net_size"], m["output_dim"]
    n_patch, n_sub = p["points_per_patch"], p["sub_sample_size"]
    flop = 0.0
    if m["use_point_stn"] and m["shared_transformation"]:
        flop += _trunk_flop(3, n_patch + n_sub, net, 4)
        flop += 2.0 * (n_patch + n_sub) * 9
    for n, point_stn in ((n_sub, m["use_point_stn"]
                          and not m["shared_transformation"]),
                         (n_patch, False)):
        if point_stn:  # a rotation of the sub-sample and of the patch
            flop += (_trunk_flop(3, n, net, 4)
                     + 2.0 * (n_sub + n_patch) * 9)
        flop += 2.0 * n * (3 * C1 + C1 * C1)  # conv0a, conv0b
        if m["use_feat_stn"]:
            flop += _trunk_flop(C1, n, net, C1 * C1)
            flop += 2.0 * n * C1 * C1  # the feature transform
        flop += 2.0 * n * (C1 * C1 + C1 * C2 + C2 * net)  # conv1-conv3
        flop += 2.0 * net * (net // 2)  # fc1_global / fc1_local
    flop += 2.0 * (net * (net // 4) + (net // 4) * (net // 8)
                   + (net // 8) * out)
    return flop
