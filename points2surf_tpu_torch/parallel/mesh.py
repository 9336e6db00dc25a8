"""The rank grid, replication and batch sharding (counterpart of
``points2surf_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a mesh with a ``data`` axis and an
optional ``model`` axis and lets XLA place the arrays; here a process is a
rank, and :func:`make_mesh` lays the ranks out the same way: a ``(data,
model)`` grid, rank ``d * model + m``, with a process group for each axis.
Parameters are replicated by broadcasting (:func:`replicate`), and each
data rank keeps its rows of a batch (:func:`shard_batch`); the wide layers'
column blocks go over the ``model`` axis (``parallel/sharding.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from points2surf_tpu_torch.parallel import distributed
from points2surf_tpu_torch.parallel.distributed import (
    Grid,
    shard_host_tree,
    world_size,
)


def _axis_groups(data: int, model: int):
    """This rank's (data group, model group). Every rank creates every
    group, in one order, as ``new_group`` requires; an axis that spans the
    world takes the default group (None) and an axis of one rank none."""
    world = data * model
    me = distributed.rank()
    mine = {"data": None, "model": None}
    axes = (("data", [[d * model + m for d in range(data)]
                      for m in range(model)]),
            ("model", [[d * model + m for m in range(model)]
                       for d in range(data)]))
    for name, groups in axes:
        size = len(groups[0])
        if size == 1 or size == world:
            continue
        for ranks in groups:
            group = dist.new_group(ranks)
            if me in ranks:
                mine[name] = group
    return mine["data"], mine["model"]


def make_mesh(*, data: int | None = None, model: int = 1) -> Grid:
    """Lay the world's ranks out as a ``(data, model)`` grid (JAX's
    ``make_mesh(data=, model=)`` over ``devices.reshape(data, model)``) and
    install it as this process's layout, the one that the helpers of
    ``parallel.distributed`` and the sharded layers read; returns it.
    ``data`` defaults to the world over ``model``. Every rank calls it, in
    the same order as its other collectives. ``model=1`` creates no group:
    the data axis is the default group, and every collective is data
    parallelism's alone."""
    world = world_size()
    if data is None:
        data = world // model
    if model < 1 or data < 1 or data * model != world:
        raise ValueError(f"a {data} x {model} grid does not fill a world of "
                         f"{world} ranks")
    data_group, model_group = _axis_groups(data, model)
    grid = Grid(data, model, distributed.rank(), data_group, model_group)
    distributed.set_grid(grid)
    return grid


@torch.no_grad()
def replicate_array(x: torch.Tensor) -> torch.Tensor:
    """Give every rank rank 0's ``x`` (identical on every rank), in place;
    returns ``x``. A world of one launches no collective."""
    if world_size() > 1:
        dist.broadcast(x, 0)
    return x


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank the parameters and buffers of data rank 0, in place
    (after init and after loading a checkpoint); returns ``module``. Column
    blocks (``parallel/sharding.py``) come from the data rank 0 that holds
    the same block, replicated tensors from rank 0. A world of one launches
    no collective."""
    if distributed.data_size() > 1:
        src = distributed.model_rank()  # global rank of (data 0, this m)
        group = distributed.data_group()
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=group)
    grid = distributed.current_grid()
    if distributed.model_size() > 1:
        sharded = {id(t) for mod in module.modules()
                   if getattr(mod, "sharded", False)
                   for t in list(mod.parameters(recurse=False))
                   + list(mod.buffers(recurse=False))}
        src = distributed.data_rank() * grid.model
        for t in list(module.parameters()) + list(module.buffers()):
            if id(t) not in sharded:
                dist.broadcast(t.data, src, group=grid.model_group)
    return module


def shard_batch(batch: dict, multiple_of: int = 1) -> dict:
    """This data rank's rows of every leading-axis tensor of a batch dict
    on the device (a batch every rank assembled whole, as mixed and test
    batches are)."""
    return shard_host_tree(batch, multiple_of)
