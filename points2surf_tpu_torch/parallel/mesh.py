"""Replication and batch sharding across ranks (counterpart of
``points2surf_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a mesh with a ``data`` axis and
lets XLA place the arrays; here a process is a rank, so there is no mesh to
build: parameters are replicated by broadcasting rank 0's
(:func:`replicate`), and each rank keeps its rows of a batch
(:func:`shard_batch`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from points2surf_tpu_torch.parallel.distributed import (
    shard_host_tree,
    world_size,
)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (after init and after
    loading a checkpoint), in place; returns ``module``. A world of one
    launches no collective."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def shard_batch(batch: dict, multiple_of: int = 1) -> dict:
    """This rank's rows of every leading-axis tensor of a batch dict on the
    device (a batch every rank assembled whole, as mixed and test batches
    are)."""
    return shard_host_tree(batch, multiple_of)
