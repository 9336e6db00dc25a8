"""Parameter partitioning over the grid's ``model`` axis: tensor parallelism
(counterpart of ``points2surf_tpu/parallel/sharding.py``).

The rule is the JAX package's, decided on each leaf's shape in JAX's layout
(a kernel is ``(in, out)``): a 2-D kernel whose last dimension is at least
``min_dim`` and divisible by the ``model`` axis is column-sharded,
``P(None, 'model')``; a 1-D leaf of such a width (bias, BatchNorm scale,
bias and running statistics) is sharded, ``P('model')``; every other leaf
is replicated. The port's weights are ``(out, in[, 1])`` (torch's layout),
so the sharded axis is dim 0 of every port tensor, and model rank ``m``
holds block ``m`` of it.

In JAX, XLA runs the sharded layers and inserts the collectives. Here a
layer that holds a block (``layer.sharded``) computes its own columns and
``parallel.distributed.gather_columns`` assembles them over the installed
grid's model ranks where the next layer needs the full width
(``models/pointnet.py``).

``param_spec`` and ``partition_like`` compute blocks and run no collective,
so they take any ``Grid`` (a hand-built one names a rank's place);
``partition_params`` and ``gather_full`` take the grid that ``make_mesh``
installed.
"""

from __future__ import annotations

import math

import torch

from points2surf_tpu_torch.parallel import distributed
from points2surf_tpu_torch.parallel.distributed import Grid

REPLICATED = ()
COLUMNS = (None, "model")
BLOCKS = ("model",)


def param_spec(path, leaf, mesh: Grid, min_dim: int = 512) -> tuple:
    """The JAX ``PartitionSpec`` of one leaf, as a tuple: ``COLUMNS`` for a
    wide 2-D kernel, ``BLOCKS`` for a 1-D leaf of such a width,
    ``REPLICATED`` (``()``) otherwise. ``leaf`` is an array in the JAX
    layout, or such a shape (``jax_shape`` of a port tensor); ``path``
    names it, as in JAX, and does not enter the rule."""
    n_model = mesh.shape.get("model", 1)
    if n_model <= 1:
        return REPLICATED
    shape = tuple(getattr(leaf, "shape", leaf))
    last = shape[-1] if shape else 1
    if last >= min_dim and last % n_model == 0:
        if len(shape) == 2:
            return COLUMNS
        if len(shape) == 1:
            return BLOCKS
    return REPLICATED


def jax_shape(t: torch.Tensor) -> torch.Size:
    """The JAX layout's shape of a port tensor: a Linear ``(out, in)`` or
    Conv1d ``(out, in, 1)`` weight is the kernel ``(in, out)``; other
    tensors keep theirs."""
    if t.dim() >= 2:
        return torch.Size((math.prod(t.shape[1:]), t.shape[0]))
    return t.shape


def _block(t: torch.Tensor, mesh: Grid) -> torch.Tensor:
    """Model rank ``mesh.model_index``'s block of dim 0."""
    size = t.shape[0] // mesh.model
    return t.narrow(0, mesh.model_index * size, size).clone()


def partition_like(tree: dict, mesh: Grid, min_dim: int = 512) -> dict:
    """This rank's blocks of a flat dict of port tensors under the rule
    (``state_dict`` names: parameters, running statistics, SGD momentum
    buffers); a leaf the rule replicates is kept whole."""
    return {k: (_block(v, mesh)
                if torch.is_tensor(v) and v.dim() >= 1
                and param_spec(k, jax_shape(v), mesh, min_dim) != REPLICATED
                else v)
            for k, v in tree.items()}


@torch.no_grad()
def partition_params(model: torch.nn.Module, mesh: Grid,
                     min_dim: int = 512) -> torch.nn.Module:
    """Keep this rank's blocks of the sharded leaves of ``model`` in place
    (``PLinear`` and ``BN`` layers; the rest stays whole) and mark each such
    layer ``layer.sharded``; returns ``model``. ``mesh`` is the installed
    grid (``make_mesh``'s), whose collectives the marked layers run. The
    model holds the full parameters before (after init, or a whole
    checkpoint loaded). Build an optimizer after this: the sharded
    parameters are new tensors."""
    distributed.installed(mesh)
    for mod in model.modules():
        leaves = dict(mod.named_parameters(recurse=False))
        leaves.update(mod.named_buffers(recurse=False))
        specs = {k: param_spec(k, jax_shape(v), mesh, min_dim)
                 for k, v in leaves.items() if v.dim() >= 1}
        if not any(s != REPLICATED for s in specs.values()):
            continue
        if any(s == REPLICATED for s in specs.values()):
            raise ValueError(f"{type(mod).__name__}: its leaves are not all "
                             f"sharded alike ({specs})")
        if not hasattr(mod, "sharded"):
            raise ValueError(f"{type(mod).__name__} has no sharded form")
        for k in specs:
            block = _block(leaves[k], mesh)
            if isinstance(leaves[k], torch.nn.Parameter):
                setattr(mod, k, torch.nn.Parameter(
                    block, requires_grad=leaves[k].requires_grad))
            else:
                setattr(mod, k, block)
        mod.sharded = True
    return model


def sharded_names(model: torch.nn.Module) -> set[str]:
    """The ``state_dict`` names of ``model``'s column blocks."""
    names = set()
    for prefix, mod in model.named_modules():
        if not getattr(mod, "sharded", False):
            continue
        for k, v in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if v.dim() >= 1:
                names.add(f"{prefix}.{k}" if prefix else k)
    return names


@torch.no_grad()
def gather_full(model: torch.nn.Module, mesh: Grid,
                tensors: dict | None = None) -> dict:
    """The whole of ``tensors`` (``state_dict`` names -> this rank's
    tensors; default ``model.state_dict()``; gradients and momentum buffers
    under the parameters' names alike), the column blocks of ``model``
    gathered over the model ranks of ``mesh`` (the installed grid): what
    reading a sharded ``jax.Array`` whole gives. Every model rank calls it;
    each gets the whole."""
    distributed.installed(mesh)
    if tensors is None:
        tensors = model.state_dict()
    sharded = sharded_names(model)
    out = {}
    for k, v in tensors.items():
        if k in sharded and mesh.model > 1:
            v = distributed.gather_blocks(
                v.detach().contiguous(), 0, mesh.model_group,
                mesh.model_index, mesh.model)
        out[k] = v
    return out
