"""Multi-process data and tensor parallelism (counterpart of
``points2surf_tpu/parallel/distributed.py``).

One process per card, started by ``torchrun``: every rank runs the same
seeded plan, takes its data rank's contiguous share of each global batch
(:func:`shard_host_batch`) and sums what the global batch needs across the
data ranks (:func:`global_sum`). In the JAX package the hosts form one SPMD
program under a device mesh, and every batch statistic is global by
construction; here each statistic is summed across ranks where it is
formed (``models/pointnet.py``), so BatchNorm normalizes over the global
batch as in JAX, not over each rank's rows as the reference's
``DataParallel`` does.

The ranks form a ``(data, model)`` grid (``parallel/mesh.make_mesh``, the
layout of JAX's ``devices.reshape(data, model)``: rank ``d * model + m``),
which ``make_mesh`` installs for the process: the helpers here and the
sharded layers read that one grid. The batch is split over the ``data``
axis; the ``model`` axis holds the column blocks of the wide layers
(``parallel/sharding.py``), whose outputs :func:`gather_columns` assembles
and whose replicated inputs take :func:`sum_input_grad`. Without a grid, or
on one with a ``model`` axis of one, every rank is a data rank, and the
helpers launch exactly the collectives of data parallelism alone.

Without a process group every helper answers as a world of one and launches
no collective.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Grid:
    """A ``(data, model)`` layout of the world's ranks as ``make_mesh``
    builds it, and this rank's place in it (``rank``). A group of None is
    the default group when the axis spans the world, and no group when the
    axis has one rank."""

    data: int
    model: int
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as JAX's ``Mesh.shape``."""
        return {"data": self.data, "model": self.model}


# the grid make_mesh installed for this process (None: every rank a data
# rank, the model axis of one); every helper below and every sharded layer
# reads it, and nothing else holds a layout
_grid: Grid | None = None


def set_grid(grid: Grid | None) -> None:
    """Install ``grid`` as this process's layout (``make_mesh`` does), or
    None for data parallelism alone."""
    global _grid
    _grid = grid


def current_grid() -> Grid | None:
    """The layout ``make_mesh`` installed (None before it)."""
    return _grid


def installed(mesh: Grid) -> Grid:
    """``mesh``, checked to be the installed layout: a function that takes
    a grid and runs or sets up collectives (``partition_params``,
    ``gather_full``, the sharded query sweep) takes the one that
    ``make_mesh`` returned, since the layers and the helpers here read that
    one."""
    if mesh is not _grid:
        raise ValueError(f"{mesh} is not the installed grid {_grid}: pass "
                         f"the one parallel.mesh.make_mesh returned")
    return mesh


def model_size() -> int:
    """Ranks on the ``model`` axis."""
    return 1 if _grid is None else _grid.model


def data_size() -> int:
    """Ranks on the ``data`` axis: the world without a grid."""
    return world_size() if _grid is None else _grid.data


def data_rank() -> int:
    """This rank's index on the ``data`` axis."""
    return rank() if _grid is None else _grid.data_index


def model_rank() -> int:
    """This rank's index on the ``model`` axis."""
    return 0 if _grid is None else _grid.model_index


def data_group():
    """The process group of this rank's data axis (None: the default
    group)."""
    return None if _grid is None else _grid.data_group


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main_process() -> bool:
    """True on the process that writes checkpoints, logs and reports."""
    return rank() == 0


def rank_rows(n: int, multiple_of: int = 1) -> tuple[int, int]:
    """(lo, hi): this data rank's contiguous share of ``n`` global rows,
    ``n // data ranks`` rounded down to ``multiple_of``; the ragged
    remainder belongs to no rank. Every model rank of a data rank takes the
    same rows."""
    per = n // data_size()
    per -= per % max(multiple_of, 1)
    return data_rank() * per, (data_rank() + 1) * per


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


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` (None: the default group) in place."""
    dist.all_reduce(t, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks, with a gradient: the backward sums
    the cotangents over them again, so a loss formed on each rank from the
    sum differentiates as the sum of the ranks' losses. One data rank
    returns ``t`` itself."""
    if data_size() == 1:
        return t
    return _GlobalSum.apply(t, data_group())


@torch.no_grad()
def mean_over_ranks_(t: torch.Tensor) -> torch.Tensor:
    """Average ``t`` over the data ranks in place (no gradient) and return
    it: the gradients of the per-rank losses, which are means over equal
    row counts, and the logged losses and metrics."""
    if data_size() > 1:
        _all_reduce(t, data_group())
        t /= data_size()
    return t


def gather_blocks(t: torch.Tensor, dim: int, group, index: int,
                  count: int) -> torch.Tensor:
    """The ``count`` ranks' blocks of ``t`` along ``dim``, rank-major (this
    rank's is block ``index``), on every rank of ``group``. It sums a
    zero-filled full-size buffer into which each rank wrote its block, one
    all-reduce that gloo and NCCL both take for CPU and CUDA tensors;
    adding zeros is exact."""
    if count == 1:
        return t
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * count
    full = t.new_zeros(shape)
    full.narrow(dim, index * size, size).copy_(t)
    return _all_reduce(full, group)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grid):
        ctx.index, ctx.size = grid.model_index, t.shape[-1]
        return gather_blocks(t, t.dim() - 1, grid.model_group,
                             grid.model_index, grid.model)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.size, ctx.size), None


class _SumInputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grid):
        ctx.group = grid.model_group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def gather_columns(t: torch.Tensor) -> torch.Tensor:
    """This rank's column block of a column-parallel layer's output (last
    axis) -> the full width on every model rank of the installed grid,
    rank-major as ``P(None, 'model')`` lays it out. The backward keeps this
    rank's columns of the cotangent: every model rank computes the same
    function of the full output, so each holds the whole cotangent."""
    if model_size() == 1:
        return t
    return _GatherColumns.apply(t, _grid)


def sum_input_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself; its cotangent summed over the model ranks of the
    installed grid. It goes on the replicated input of every
    column-parallel layer: each model rank's columns contribute their part
    of the input's gradient, and the sum gives every rank the whole of it,
    so the replicated layers below receive the same gradient on every model
    rank."""
    if model_size() == 1:
        return t
    return _SumInputGrad.apply(t, _grid)
