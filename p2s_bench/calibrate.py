"""Read the numbers the check compares, for many seeds in one process, to
set the limits of a cell (not part of a benchmark run):

    python3 p2s_bench/calibrate.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--control <k>]

For each seed: the cell's set-up, a window of ``--seconds`` and the check
of what it produced (the program's readings, the lower end of each limit);
for the first ``--control`` seeds also the control, the reference computed
in TF32 in the program's place (the upper end). ``--fault`` plants one of a
training cell's faults in the program instead: ``frozen`` (a step that
leaves its state unchanged) or ``half`` (half of each batch left out, the
mean taken over the rest). ``--witness`` (training cells) also runs the
float32 reference again with each batch's rows in another order and reads
it against the reference as the program is: where the worst parameter of
both reads alike, that number swings with rounding and not with the
program. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import run  # noqa: E402


def plant(fault: str) -> None:
    """Break the program's train step underneath the timed path."""
    from points2surf_tpu_torch.models import losses
    from points2surf_tpu_torch.train.trainer import TrainStep

    if fault == "frozen":
        TrainStep.update = lambda self: None
        return
    real = losses.compute_loss

    def half(pred, batch, *args, **kwargs):
        rows = len(pred) // 2
        return real(pred[:rows], {k: v[:rows] for k, v in batch.items()},
                    *args, **kwargs)

    losses.compute_loss = half


def witness(driver, seed: int) -> dict:
    """Whether the training check's worst parameter swings with float32
    rounding alone: the float32 reference run again on the same batches
    with their rows in another order (the batch statistics, the loss and
    every weight gradient summed in another order, nothing else changed),
    read against the reference as the program is. Per quantity (the first
    gradient, the change after the checked steps) the worst parameter's gap
    and its name, and the median's; each step's loss gap."""
    import torch

    from reference import train as ref_train

    batches = driver._reference_batches()
    weights = {k: v.to(driver.dev) for k, v in driver.weights.items()}
    tr = harness.traffic("train")
    perm = torch.randperm(driver.batch, generator=torch.Generator()
                          .manual_seed(seed % 2 ** 63)).to(driver.dev)
    shuffled = [[dict(run, rows=perm[run["rows"]]) for run in runs]
                for runs in batches]
    want = tr._norms(*ref_train.run_steps(driver.cfg, weights, batches))
    other = tr._norms(*ref_train.run_steps(driver.cfg, weights, shuffled))
    out = {}
    for who, got in (("program", driver.prog), ("reordered", other)):
        for q in ("grad", "delta"):
            gaps = tr.leaf_gaps(got[q], want[q], want["grad"])
            worst = max(gaps, key=gaps.get)
            out[f"{who}.{q}"] = {"worst": gaps[worst], "leaf": worst,
                                 "median": float(np.median(list(
                                     gaps.values())))}
        out[f"{who}.loss"] = [abs(a - b) / abs(b) for a, b in
                              zip(got["losses"], want["losses"])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", choices=("frozen", "half"))
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import points2surf_tpu_torch  # noqa: F401

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    run.prebuild()
    wl, _ = harness.cell(args.workload)
    if args.fault:
        plant(args.fault)
    for i, seed in enumerate(args.seeds):
        ctx = harness.context(args.workload, seed, "cuda")
        driver = harness.traffic(wl["traffic"]).Traffic(ctx)
        result = driver.window(args.seconds)
        driver.free()
        gc.collect()
        torch.cuda.empty_cache()
        kinds = ["program"] + (["control"] if i < args.control else [])
        for kind in kinds:
            checks = driver.check(tf32=kind == "control")
            correct = run.judge(checks, wl["limits"])[0]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": args.fault or kind,
                              "correct": correct,
                              "work": result["work"],
                              "checks": dict(checks),
                              "tie_rows": getattr(driver, "tie_rows",
                                                  None)}),
                  flush=True)
        if args.witness:
            print(json.dumps(dict(witness(driver, seed),
                                  workload=args.workload, seed=seed)),
                  flush=True)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
