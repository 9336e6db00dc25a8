"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for sm_90a into a shared library, at its first use, under the
package's ``build/`` directory (keyed by a hash of the source and the
headers of ``csrc/``), and loaded with ``ctypes``. Nothing is built when a
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_tag(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def compile_library(out_dir: Path, lib_name: str, cmd: list[str],
                    what: str) -> tuple[Path, str]:
    """Run the compiler command ``cmd`` with ``-o <temporary file>`` appended
    and move the result to ``out_dir/lib_name`` in one rename, unless that
    library exists already. Returns (library path, compiler log); raises
    with the log if the compiler fails. Safe to call from several threads
    or processes at once (each writes its own temporary file)."""
    lib = out_dir / lib_name
    log = out_dir / "build.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed on {what} "
                           f"({proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, text


def build_library(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a. Returns (library path, compiler
    log); an existing build of the same sources is reused. Safe to call for
    several sources at once from threads (one ``nvcc`` each)."""
    source = CSRC / f"{name}.cu"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           str(source)]
    return compile_library(BUILD_DIR / f"{name}-{_source_tag(source)}",
                           f"libp2s_{name}.so", cmd, source.name)


VP, CI = ctypes.c_void_p, ctypes.c_int


@functools.cache
def load_library(name: str, entry_points: tuple) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``entry_points`` is a
    tuple of (function name, argtypes) pairs. Every entry returns an int
    (a ``cudaError_t``)."""
    path, _ = build_library(name)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in entry_points:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = CI
    return lib


@functools.cache
def sm_count(dev: int) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (the persistent
    kernels' launch plans)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
