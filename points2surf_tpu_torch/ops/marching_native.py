"""ctypes loader of the C++ marching tetrahedra (``csrc/marching.cpp``),
counterpart of ``points2surf_tpu/ops/marching_native.py``.

The source is compiled by ``g++ -O3 -fopenmp -shared -fPIC`` at its first
use into ``build/marching-<source hash>/`` of the package (the scheme of
``ops/kernels/build.py``: keyed by a hash of the source and the flags,
written under a temporary name and renamed, safe from threads). A failed
build raises with the compiler's log. Outputs are interchangeable with the
numpy version (same decomposition and case table), and come out in one
fixed order whatever the number of OpenMP threads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np

from points2surf_tpu_torch.ops.kernels.build import (
    BUILD_DIR, CSRC, compile_library)

SOURCE = CSRC / "marching.cpp"
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def build_library(source=SOURCE, build_dir=BUILD_DIR):
    """Compile ``source`` with g++ unless a build of the same source and
    flags exists. Returns (library path, compiler log)."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    out_dir = build_dir / f"{source.stem}-{h.hexdigest()[:16]}"
    return compile_library(out_dir, f"libp2s_{source.stem}.so",
                           ["g++", *FLAGS, str(source)], source.name)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0,
                        threads: int = 0):
    """Native isosurface extraction; same contract as the numpy version in
    ``ops/marching_cubes.py``. ``threads`` > 0 sets the number of OpenMP
    threads (0: the OpenMP default); the result does not depend on it."""
    lib = _library()
    vol = np.ascontiguousarray(vol, np.float32)
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D volume, got shape {vol.shape}")
    rx, ry, rz = vol.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_extract(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rx, ry, rz, ctypes.c_float(level), int(threads),
        ctypes.byref(verts_p), ctypes.byref(faces_p),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise MemoryError("mt_extract failed")
    if nv.value == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    try:
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(faces_p, (nf.value, 3)).copy()
    finally:
        lib.mt_free(verts_p)
        lib.mt_free(faces_p)

    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]
