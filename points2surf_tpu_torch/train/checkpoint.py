"""Checkpoints in the JAX package's layout (counterpart of
``points2surf_tpu/train/checkpoint.py``), so a checkpoint moves both ways
between the packages.

A checkpoint is a flat ``.npz`` keyed by the tree paths that
``jax.tree_util.keystr`` writes: ``"['params']['feat_global']['conv1']
['linear']['kernel']"`` (flax layout, kernels (in, out)),
``"['batch_stats'][...]['norm']['mean']"``, and the ``optax.sgd`` state
``"['opt_state'][0].trace[...]"`` and ``"['opt_state'][1].count"``
(``models/weights.py`` converts the port's modules to and from these
trees). The training options go to a JSON sidecar (the reference pickles
its argparse namespace into ``*_params.pth``; that still loads for eval).
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import torch

from points2surf_tpu_torch.models.weights import (
    flax_from_state_dict,
    keystr,
    nest,
    state_dict_from_flax,
)
from points2surf_tpu_torch.utils import file_utils

_SEGMENT = re.compile(r"\['([^']*)'\]")


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of arrays -> {keystr path: array}."""
    out = {}
    for key, val in tree.items():
        path = prefix + keystr((key,))
        if isinstance(val, dict):
            out.update(flatten(val, path))
        else:
            out[path] = val
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The entries of ``flat`` under ``prefix`` (dict keys only) -> nested
    dicts, the inverse of :func:`flatten`."""
    return nest([(tuple(_SEGMENT.findall(k[len(prefix):])), v)
                 for k, v in flat.items() if k.startswith(prefix)])


def model_state(model: torch.nn.Module) -> dict:
    """The ``['params']`` and ``['batch_stats']`` entries of ``model``."""
    params, stats = flax_from_state_dict(model.state_dict())
    return flatten({"params": params, "batch_stats": stats})


def load_model_state(model: torch.nn.Module, flat: dict) -> None:
    """Load the ``['params']`` and ``['batch_stats']`` entries of a
    checkpoint into ``model`` (strict)."""
    model.load_state_dict(state_dict_from_flax(
        unflatten(flat, "['params']"), unflatten(flat, "['batch_stats']")),
        strict=True)


def save_state(path: str, flat: dict) -> None:
    """Write ``flat`` ({keystr path: array}) as an ``.npz``, atomically: to
    a temporary file beside ``path``, then one ``os.replace``."""
    file_utils.make_dir_for_file(path)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    os.replace(tmp, path)


def load_state(path: str, keys=None, strict: bool = True) -> dict:
    """{keystr path: array} of a checkpoint. With ``keys`` (the entries the
    caller needs), a missing one raises when ``strict`` and is left out
    otherwise; other entries of the file are not read."""
    with np.load(path) as data:
        if keys is None:
            return {k: data[k] for k in data.files}
        missing = [k for k in keys if k not in data.files]
        if missing and strict:
            raise KeyError(f"checkpoint {path} is missing {missing[0]}")
        return {k: data[k] for k in keys if k in data.files}


def save_params_namespace(path: str, opt) -> None:
    file_utils.make_dir_for_file(path)
    d = {k: v for k, v in vars(opt).items()}
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)


def load_params_namespace(path: str):
    import argparse

    with open(path) as f:
        d = json.load(f)
    return argparse.Namespace(**d)


def epoch_from_filename(path: str) -> int:
    """Parse '<name>_model_<epoch>.*' -> epoch + 1, else 0
    (reference points_to_surf_train.py:267-282)."""
    stem = os.path.basename(path)
    m = re.search(r"_(\d+)\.[^.]+$", stem)
    return int(m.group(1)) + 1 if m else 0


def is_snapshot_epoch(epoch: int, nepoch: int) -> bool:
    """Log-spaced immutable snapshots: epochs 0,5,10,50,100,500,... plus
    every 100 and the final epoch (reference train.py:516)."""
    base = 5 * 10 ** math.floor(math.log10(max(2, epoch - 1)))
    return epoch % base == 0 or epoch % 100 == 0 or epoch == nepoch - 1
