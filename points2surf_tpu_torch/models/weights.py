"""Weights bridge: JAX/flax parameter trees, optax SGD state and reference
``.pth`` files.

``state_dict_from_flax`` mirrors ``export_state_dict`` of
``points2surf_tpu/models/import_torch.py`` with numpy alone (no jax, no
import of the JAX package): flax Dense kernels (in, out) become Conv1d
weights (out, in, 1) for ``conv*`` layers and Linear weights (out, in)
otherwise; ``norm/{scale, bias}`` and ``batch_stats`` ``{mean, var}`` become
BatchNorm ``weight/bias/running_mean/running_var``; the ``trunk`` level of
STN/QSTN modules is dropped. ``sgd_state_from_checkpoint`` does the same for
the momentum trace of an ``optax.sgd`` state as the JAX package's
checkpoints store it.

``flax_from_state_dict`` and ``sgd_state_to_checkpoint`` are the inverses:
they turn the port's model and SGD state into the JAX package's trees and
checkpoint keys, so ``train/checkpoint.py`` writes files that the JAX
package loads.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_key(path) -> str:
    # path ends (layer, kind, leaf); 'trunk' levels do not exist in torch
    return ".".join(p for p in path[:-2] if p != "trunk")


# flax modules that hold their layers one level down, under 'trunk'
_STN_NAMES = ("point_stn", "stn1", "stn2")


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def state_dict_from_flax(params: dict, batch_stats: dict | None = None
                         ) -> dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (flax ``params``, ``batch_stats``) -> a
    reference-layout torch ``state_dict``."""
    state: dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val)
        layer, kind, leaf = path[-3], path[-2], path[-1]
        base = _torch_key(path)
        if kind == "norm" and leaf in ("scale", "bias"):
            state[base + (".weight" if leaf == "scale" else ".bias")] = val
            state.setdefault(base + ".num_batches_tracked",
                             np.asarray(0, np.int64))
        elif kind == "linear" and leaf == "kernel":
            w = val.T[:, :, None] if layer.startswith("conv") else val.T
            state[base + ".weight"] = w
        elif kind == "linear" and leaf == "bias":
            state[base + ".bias"] = val
        else:
            raise ValueError(f"unexpected param path: {path}")
    for path, val in _flatten(batch_stats or {}):
        base = _torch_key(path)
        leaf = path[-1]
        if leaf not in ("mean", "var"):
            raise ValueError(f"unknown batch_stats leaf: {path}")
        state[base + (".running_mean" if leaf == "mean"
                      else ".running_var")] = np.asarray(val)
        state.setdefault(base + ".num_batches_tracked",
                         np.asarray(0, np.int64))
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def nest(items) -> dict:
    """(path tuple, value) pairs -> nested dicts."""
    tree: dict = {}
    for path, val in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def _flax_path(module: str) -> tuple:
    """Torch module path 'a.stn1.conv1' -> flax path ('a', 'stn1', 'trunk',
    'conv1')."""
    out = []
    for part in module.split("."):
        out.append(part)
        if part in _STN_NAMES:
            out.append("trunk")
    return tuple(out)


def flax_from_state_dict(state_dict) -> tuple[dict, dict]:
    """A reference-layout torch ``state_dict`` -> (``params``,
    ``batch_stats``): nested dicts of float32 numpy arrays in flax's layout,
    the inverse of :func:`state_dict_from_flax`. Conv weights (out, in, 1)
    and Linear weights (out, in) become kernels (in, out); BatchNorm weight /
    bias / running statistics become ``norm/{scale, bias}`` and
    ``{mean, var}``; ``num_batches_tracked`` is dropped. Momentum buffers
    (parameters only) convert alike."""
    params, stats = [], []
    for key, val in state_dict.items():
        val = np.asarray(val.detach().cpu() if torch.is_tensor(val) else val)
        module, leaf = key.rsplit(".", 1)
        path = _flax_path(module)
        if leaf == "num_batches_tracked":
            continue
        if module.rsplit(".", 1)[-1].startswith("bn"):  # BatchNorm layers
            if leaf in ("running_mean", "running_var"):
                stats.append((path + ("norm", leaf[len("running_"):]), val))
            else:
                params.append((path + ("norm", "scale" if leaf == "weight"
                                       else "bias"), val))
        elif leaf == "weight":
            w = val[:, :, 0] if val.ndim == 3 else val
            params.append((path + ("linear", "kernel"), w.T))
        elif leaf == "bias":
            params.append((path + ("linear", "bias"), val))
        else:
            raise ValueError(f"unexpected state_dict key: {key}")
    as_f32 = [(p, np.ascontiguousarray(v, np.float32)) for p, v in params]
    return (nest(as_f32),
            nest([(p, np.ascontiguousarray(v, np.float32))
                        for p, v in stats]))


def sgd_state_to_checkpoint(buffers: dict, count: int,
                            prefix: str = "['opt_state']") -> dict:
    """Per-parameter momentum buffers under the ``state_dict`` names and the
    step count -> the flat checkpoint entries of an ``optax.sgd`` state
    (``"['opt_state'][0].trace[...]"`` float32 and ``"['opt_state'][1].count"``
    int32), the inverse of :func:`sgd_state_from_checkpoint`."""
    trace, _ = flax_from_state_dict(buffers)
    flat = {prefix + "[0].trace" + keystr(path): val
            for path, val in _flatten(trace)}
    flat[prefix + "[1].count"] = np.asarray(count, np.int32)
    return flat


def sgd_state_from_checkpoint(flat, prefix: str = "['opt_state']"
                              ) -> tuple[dict[str, torch.Tensor], int | None]:
    """The ``optax.sgd(..., momentum=...)`` state in a JAX checkpoint -> the
    per-parameter momentum buffers under the reference ``state_dict`` names,
    and the step count (None when the learning rate was a constant).

    ``flat`` maps the tree paths that ``points2surf_tpu/train/checkpoint.py``
    writes (``"['opt_state'][0].trace['feat_global']['conv1']['linear']
    ['kernel']"``, ``"['opt_state'][1].count"``) to numpy arrays, as
    ``np.load`` of its ``.npz`` returns them."""
    trace = prefix + "[0].trace"
    items = [(tuple(re.findall(r"\['([^']*)'\]", key[len(trace):])), val)
             for key, val in flat.items() if key.startswith(trace)]
    if not items:
        raise ValueError(f"no SGD momentum trace under {trace}")
    buffers = {k: v for k, v in state_dict_from_flax(nest(items)).items()
               if not k.endswith(".num_batches_tracked")}
    count = flat.get(prefix + "[1].count")
    return buffers, None if count is None else int(np.asarray(count))


def load_reference_pth(model: nn.Module, path: str) -> nn.Module:
    """Load a reference ``.pth`` checkpoint into ``model`` (strict). Keys of
    ``DataParallel``-saved files lose their ``module.`` prefix."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.removeprefix("module."): v for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model
