"""Training entry point (counterpart of ``points2surf_tpu/cli/full_train.py``;
reference full_train.py / points_to_surf_train.py).

Usage: python -m points2surf_tpu_torch.cli.full_train --name vanilla --indir ...
       torchrun --nproc_per_node=N -m points2surf_tpu_torch.cli.full_train ...

Under ``torchrun`` each rank trains on ``cuda:<LOCAL_RANK>`` with its share
of every batch and the global batch's statistics (``parallel/``); rank 0
writes the TensorBoard log, the checkpoints and the params.
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
    from points2surf_tpu_torch.parallel import distributed
    from points2surf_tpu_torch.train.trainer import Trainer

    writer = None
    if distributed.is_main_process():
        log_dirname = os.path.join(opt.logdir, opt.name)
        # run-collision handling (reference train.py:183-198);
        # non-interactive: fresh runs overwrite silently, matching
        # automated use
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
    from points2surf_tpu_torch.parallel import distributed

    # a torchrun launch joins its process group; a plain run is one process
    if distributed.initialize():
        print(f"multi-process: rank {distributed.rank()}/"
              f"{distributed.world_size()} on cuda:"
              f"{distributed.local_rank()}, batch statistics over the "
              f"global batch")
    opt = parse_arguments(args)
    points_to_surf_train(opt, device=device_of(opt))


if __name__ == "__main__":
    main()
