"""Multi-process data parallelism (counterpart of
``points2surf_tpu/parallel/distributed.py``).

One process per card, started by ``torchrun``: every rank runs the same
seeded plan, takes its contiguous share of each global batch
(:func:`shard_host_batch`) and sums what the global batch needs across
ranks (:func:`global_sum`). In the JAX package the hosts form one SPMD
program under a device mesh, and every batch statistic is global by
construction; here each statistic is summed across ranks where it is
formed (``models/pointnet.py``), so BatchNorm normalizes over the global
batch as in JAX, not over each rank's rows as the reference's
``DataParallel`` does.

Without a process group every helper answers as a world of one and launches
no collective.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(backend: str | None = None,
               init_method: str = "env://") -> bool:
    """Join the process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` / ``MASTER_PORT`` through
    ``init_method``). Returns False, and does nothing, outside such a launch,
    so a driver can call it unconditionally.

    ``backend`` defaults to nccl where a card is present (each rank on
    ``cuda:<LOCAL_RANK>``) and gloo otherwise; gloo also takes CUDA tensors,
    which lets several ranks share one card. ``init_method`` may name a
    ``file://`` store in place of the environment's address.
    """
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main_process() -> bool:
    """True on the process that writes checkpoints, logs and reports."""
    return rank() == 0


def rank_rows(n: int, multiple_of: int = 1) -> tuple[int, int]:
    """(lo, hi): this rank's contiguous share of ``n`` global rows, ``n //
    world`` rounded down to ``multiple_of``; the ragged remainder belongs
    to no rank."""
    per = n // world_size()
    per -= per % max(multiple_of, 1)
    return rank() * per, (rank() + 1) * per


def shard_host_batch(global_indices, multiple_of: int = 1):
    """This rank's slice of a global batch (numpy array or tensor) along its
    leading axis, as :func:`rank_rows` gives it."""
    lo, hi = rank_rows(len(global_indices), multiple_of)
    return global_indices[lo:hi]


def shard_host_tree(batch: dict, multiple_of: int = 1) -> dict:
    """This rank's slice of every leading-axis array in a batch dict."""
    return {k: shard_host_batch(v, multiple_of) for k, v in batch.items()}


def barrier(name: str) -> None:
    """Wait until every rank arrives (``sync_global_devices(name)`` in the
    JAX package); a no-op in a world of one. ``name`` labels the error if
    the group fails."""
    if world_size() == 1:
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank, with a gradient: the backward sums the
    cotangents over the ranks again, so a loss formed on each rank from the
    sum differentiates as the sum of the ranks' losses. A world of one
    returns ``t`` itself."""
    if world_size() == 1:
        return t
    return _GlobalSum.apply(t)


@torch.no_grad()
def mean_over_ranks_(t: torch.Tensor) -> torch.Tensor:
    """Average ``t`` over the ranks in place (no gradient) and return it:
    the gradients of the per-rank losses, which are means over equal row
    counts, and the logged losses and metrics."""
    if world_size() > 1:
        dist.all_reduce(t)
        t /= world_size()
    return t
