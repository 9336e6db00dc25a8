"""Training entry point (counterpart of ``points2surf_tpu/cli/full_train.py``;
reference full_train.py / points_to_surf_train.py).

Usage: python -m points2surf_tpu_torch.cli.full_train --name vanilla --indir ...
"""

from __future__ import annotations

import os
import shutil


def _summary_writer(log_dirname: str, name: str):
    """A TensorBoard writer, or None (and one line saying so) when
    ``torch.utils.tensorboard`` does not import or start. Logging only: a
    run without it trains the same."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dirname, comment=name)
    except Exception as e:  # missing or mismatched tensorboard install
        print(f"TensorBoard logging off: {type(e).__name__}: {e}")
        return None


def points_to_surf_train(opt, device="cuda"):
    """Train the model of ``opt`` (``cli/train_args``) on ``device``."""
    from points2surf_tpu_torch.train.trainer import Trainer

    log_dirname = os.path.join(opt.logdir, opt.name)
    # run-collision handling (reference train.py:183-198); non-interactive:
    # fresh runs overwrite silently, matching automated use
    if os.path.exists(log_dirname):
        shutil.rmtree(log_dirname, ignore_errors=True)

    writer = _summary_writer(log_dirname, opt.name)
    if writer is not None:
        writer.add_scalar("LR", opt.lr, 0)
    try:
        trainer = Trainer(opt, log_writer=writer, device=device)
        print(
            f"Training set: {len(trainer.train_sampler)} patches "
            f"({trainer.steps_per_epoch} batches) | "
            f"Test set: {len(trainer.test_sampler)} patches | "
            f"model: {trainer.num_params / 1e6:.1f}M params"
        )
        trainer.train()
    finally:
        if writer is not None:
            writer.close()
    return trainer


def main(args=None):
    from points2surf_tpu_torch.cli.train_args import device_of, parse_arguments

    opt = parse_arguments(args)
    points_to_surf_train(opt, device=device_of(opt))


if __name__ == "__main__":
    main()
