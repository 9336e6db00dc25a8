"""Time and record the PyTorch port's pooled kernels of one checkout, to
compare two checkouts on the same card.

    python scripts/torch_kernel_ab.py --root DIR --out DIR/ab.pt
    python scripts/torch_kernel_ab.py --root . --out new.pt --compare old.pt

Imports ``points2surf_tpu_torch`` from ``--root`` (its kernels build there),
runs ``chain_pool`` (max pool) at the query forward's five call sites at
batch 4096 and ``mlp_maxpool`` at four encoder-tail shapes on seeded
inputs, prints each call's mean device time (CUDA events) and saves the
outputs. With ``--compare`` it also prints, per case, whether the outputs
are bit-identical to the other file's and their max abs difference. Run the
two checkouts in turns (old, new, new, old) in one call on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

NET = 1024
BATCH = 4096
CHAIN_SITES = ((3, 1300, 1), (64, 1000, 2), (64, 300, 2))
MLP_SHAPES = ((16, 256, 128, 512), (64, 300, 128, NET),
              (1000, 300, 128, NET), (1000, 1000, 128, NET))


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool
    from points2surf_tpu_torch.ops.kernels.mlp_maxpool import mlp_maxpool

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    outs = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    chains_ms = 0.0
    for cin, n, count in CHAIN_SITES:
        x = torch.randn((BATCH, n, cin), generator=gen, device=dev)
        layers, ci = [], cin
        for co in (64, 128, NET):
            w = torch.randn((ci, co), generator=gen, device=dev) / ci ** 0.5
            a = torch.rand((co,), generator=gen, device=dev) * 2.0 - 0.5
            c = torch.randn((co,), generator=gen, device=dev) * 0.1
            layers.append((w, a, c))
            ci = co
        key = f"chain_pool {BATCH}x{n}x{cin}"
        outs[key] = chain_pool(x, layers).cpu()
        ms = _events_ms(torch, lambda: chain_pool(x, layers), 5)
        chains_ms += count * ms
        print(f"{args.root}: {key} {ms:.4f} ms")
        del x
    print(f"{args.root}: five chains of one batch-{BATCH} forward "
          f"{chains_ms:.4f} ms")
    for b, n, cin, cout in MLP_SHAPES:
        x = torch.randn((b, n, cin), generator=gen, device=dev)
        w = torch.randn((cin, cout), generator=gen, device=dev) * 0.1
        c = torch.randn((cout,), generator=gen, device=dev)
        key = f"mlp_maxpool {b}x{n}x{cin}->{cout}"
        outs[key] = mlp_maxpool(x, w, c).cpu()
        iters = 200 if b * n < 100_000 else 5
        ms = _events_ms(torch, lambda: mlp_maxpool(x, w, c), iters)
        print(f"{args.root}: {key} {ms:.4f} ms")
    torch.save(outs, args.out)
    if args.compare:
        other = torch.load(args.compare)
        for key, got in outs.items():
            diff = float((got - other[key]).abs().max())
            print(f"{key}: bit-identical {torch.equal(got, other[key])}, "
                  f"max abs diff {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
