"""File utilities (counterpart of the part of
``points2surf_tpu/utils/file_utils.py`` that meshing and the data pipeline
use): the directory of an output file, the mtime test of an incremental
build, and the cached ``.npy`` load of a text array."""

from __future__ import annotations

import os

import numpy as np


def make_dir_for_file(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def call_necessary(file_in, file_out, min_file_size: int = 0) -> bool:
    """mtime-based incremental-build predicate (reference file_utils.py:194-247).

    True when any output is missing/too small or older than the newest input.
    Missing inputs count as 'necessary' (the callee will raise a clearer
    error than we could here).
    """
    if isinstance(file_in, str):
        file_in = [file_in]
    if isinstance(file_out, str):
        file_out = [file_out]

    inputs_missing = [f for f in file_in if not os.path.isfile(f)]
    if inputs_missing:
        return True

    if not file_out:
        return True

    for f in file_out:
        if not os.path.isfile(f):
            return True
        if os.path.getsize(f) < min_file_size:
            return True

    oldest_output = min(os.path.getmtime(f) for f in file_out)
    newest_input = max(os.path.getmtime(f) for f in file_in)
    return newest_input >= oldest_output


def load_npy_if_valid(
    path_without_npy: str, dtype: str = "float32", mmap_mode=None
) -> np.ndarray:
    """Load `<path>.npy` if present, else convert the text file once
    (reference file_utils.py:250-254 + data_loader load_pts)."""
    npy = path_without_npy + ".npy"
    if os.path.isfile(npy):
        arr = np.load(npy, mmap_mode=mmap_mode)
    else:
        arr = np.loadtxt(path_without_npy).astype(dtype)
        np.save(npy, arr)
    if arr.dtype != np.dtype(dtype):
        arr = arr.astype(dtype)
    return arr
