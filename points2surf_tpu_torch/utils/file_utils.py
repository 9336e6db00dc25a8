"""File utilities (counterpart of ``points2surf_tpu/utils/file_utils.py``):
the per-file seed, the directory of an output file, the mtime test of an
incremental build, the cached ``.npy`` load of a text array and the
single-array npz container."""

from __future__ import annotations

import hashlib
import os

import numpy as np


def filename_to_hash(file_path: str) -> int:
    """Deterministic per-file seed (reference file_utils.py:6-12)."""
    h = hashlib.md5(os.path.basename(file_path).encode()).hexdigest()
    return int(h, 16) % (2**32)


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


def save_npz(path: str, arr) -> None:
    """Sparse-friendly compressed single-array container
    (reference file_utils.py:28-73 role)."""
    np.savez_compressed(path, arr=arr)


def load_npz(path: str):
    with np.load(path) as d:
        return d["arr"] if "arr" in d.files else d[d.files[0]]
