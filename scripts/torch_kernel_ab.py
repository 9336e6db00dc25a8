"""Time and record the PyTorch port's pooled kernels of one checkout, to
compare two checkouts on the same card.

    python scripts/torch_kernel_ab.py --root DIR --out DIR/ab.pt
    python scripts/torch_kernel_ab.py --root . --out new.pt --compare old.pt

Imports ``points2surf_tpu_torch`` from ``--root`` (its kernels build there),
runs ``chain_pool`` (max pool) and ``chain_head`` (its layers 1-2) at the
query forward's five call sites at batch 4096, ``mlp_maxpool`` at four
encoder-tail shapes and ``pooled_tail`` at the train step's three
conv3-tail shapes at batch 1000 on seeded inputs, ``chain_pool_bf16`` and
``pooled_tail_bf16`` the same in the bf16-operand mode (``chain_pool_bf16``
runs ``chain_fused`` in a checkout that has it, the split pair in an older
one; ``--kernels`` picks some of the six; a checkout older than the bf16
mode has only the other four), prints each call's mean device time (CUDA
events) and saves the outputs. With ``--compare``
it also prints, per case, whether the outputs are bit-identical to the
other file's and their max abs difference. Run the two checkouts in turns
(old, new, new, old) in one call on one card.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys

NET = 1024
BATCH = 4096
CHAIN_SITES = ((3, 1300, 1), (64, 1000, 2), (64, 300, 2))
MLP_SHAPES = ((16, 256, 128, 512), (64, 300, 128, NET),
              (1000, 300, 128, NET), (1000, 1000, 128, NET))
TRAIN_BATCH = 1000
TAIL_SITES = ((1300, 1), (1000, 2), (300, 2))
TAIL_NAMES = ("cmax", "amax", "cmin", "amin", "rsum", "rsq")


def _events_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _random_layers(torch, gen, dev, cin, widths):
    """(W, a, c) triples of a chain from ``cin`` through ``widths``."""
    layers, ci = [], cin
    for co in widths:
        w = torch.randn((ci, co), generator=gen, device=dev) / ci ** 0.5
        a = torch.rand((co,), generator=gen, device=dev) * 2.0 - 0.5
        c = torch.randn((co,), generator=gen, device=dev) * 0.1
        layers.append((w, a, c))
        ci = co
    return layers


def _chain_pool(torch, dev, root, outs, bf16=False):
    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool

    kw = {"bf16_operands": True} if bf16 else {}
    name = "chain_pool_bf16" if bf16 else "chain_pool"
    gen = torch.Generator(device=dev).manual_seed(0)
    chains_ms = 0.0
    for cin, n, count in CHAIN_SITES:
        x = torch.randn((BATCH, n, cin), generator=gen, device=dev)
        layers = _random_layers(torch, gen, dev, cin, (64, 128, NET))
        key = f"{name} {BATCH}x{n}x{cin}"
        outs[key] = chain_pool(x, layers, **kw).cpu()
        ms = _events_ms(torch, lambda: chain_pool(x, layers, **kw), 5)
        chains_ms += count * ms
        print(f"{root}: {key} {ms:.4f} ms")
        del x
    print(f"{root}: {name}: five chains of one batch-{BATCH} forward "
          f"{chains_ms:.4f} ms")


def _chain_head(torch, dev, root, outs):
    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_head

    gen = torch.Generator(device=dev).manual_seed(3)
    heads_ms = 0.0
    for cin, n, count in CHAIN_SITES:
        x = torch.randn((BATCH, n, cin), generator=gen, device=dev)
        layers = _random_layers(torch, gen, dev, cin, (64, 128))
        key = f"chain_head {BATCH}x{n}x{cin}"
        # every 64th row of h2 (the whole of it is 5.4 GB over the sites)
        outs[key] = chain_head(x, layers)[::64].cpu()
        ms = _events_ms(torch, lambda: chain_head(x, layers), 10)
        heads_ms += count * ms
        print(f"{root}: {key} {ms:.4f} ms")
        del x
    print(f"{root}: chain_head: five heads of one batch-{BATCH} forward "
          f"{heads_ms:.4f} ms")


def _mlp_maxpool(torch, dev, root, outs):
    from points2surf_tpu_torch.ops.kernels.mlp_maxpool import mlp_maxpool

    gen = torch.Generator(device=dev).manual_seed(1)
    for b, n, cin, cout in MLP_SHAPES:
        x = torch.randn((b, n, cin), generator=gen, device=dev)
        w = torch.randn((cin, cout), generator=gen, device=dev) * 0.1
        c = torch.randn((cout,), generator=gen, device=dev)
        key = f"mlp_maxpool {b}x{n}x{cin}->{cout}"
        outs[key] = mlp_maxpool(x, w, c).cpu()
        iters = 200 if b * n < 100_000 else 5
        ms = _events_ms(torch, lambda: mlp_maxpool(x, w, c), iters)
        print(f"{root}: {key} {ms:.4f} ms")


def _pooled_tail(torch, dev, root, outs, bf16=False):
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)

    kw = {"bf16_operands": True} if bf16 else {}
    name = "pooled_tail_bf16" if bf16 else "pooled_tail"
    gen = torch.Generator(device=dev).manual_seed(2)
    tails_ms = 0.0
    for n, count in TAIL_SITES:
        x = torch.relu(torch.randn((TRAIN_BATCH, n, 128), generator=gen,
                                   device=dev))
        w = torch.randn((128, NET), generator=gen, device=dev) / 128 ** 0.5
        b = torch.randn((NET,), generator=gen, device=dev) * 0.1
        key = f"{name} {TRAIN_BATCH}x{n}x128->{NET}"
        for out, o in zip(TAIL_NAMES, pooled_tail_reductions(x, w, b, **kw)):
            outs[f"{key} {out}"] = o.cpu()
        ms = _events_ms(torch, lambda: pooled_tail_reductions(x, w, b, **kw),
                        10)
        tails_ms += count * ms
        print(f"{root}: {key} {ms:.4f} ms")
        del x
    print(f"{root}: {name}: five conv3 tails of one batch-{TRAIN_BATCH} "
          f"train step {tails_ms:.4f} ms")


KERNELS = {"chain_pool": _chain_pool, "chain_head": _chain_head,
           "mlp_maxpool": _mlp_maxpool,
           "pooled_tail": _pooled_tail,
           "chain_pool_bf16": functools.partial(_chain_pool, bf16=True),
           "pooled_tail_bf16": functools.partial(_pooled_tail, bf16=True)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare")
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS),
                    default=list(KERNELS))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    outs = {}
    for name in args.kernels:
        KERNELS[name](torch, dev, args.root, outs)
    torch.save(outs, args.out)
    if args.compare:
        other = torch.load(args.compare)
        for key, got in outs.items():
            diff = float((got.double() - other[key].double()).abs().max())
            print(f"{key}: bit-identical {torch.equal(got, other[key])}, "
                  f"max abs diff {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
