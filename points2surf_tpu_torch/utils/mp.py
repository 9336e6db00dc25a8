"""Process-pool fan-out for the host stages (counterpart of
``points2surf_tpu/utils/mp.py``; reference source/base/utils_mp.py): the
metrics' mesh comparisons, dataset generation's convert / clean / normalize
stages and the external tools (Blender, meshlab)."""

from __future__ import annotations

import multiprocessing
import subprocess


def start_process_pool(worker_function, parameters, num_processes,
                       timeout=None):
    """Serial when num_processes <= 1 (or one task), else a Pool of at most
    one worker per task with maxtasksperchild=1 (worker isolation,
    reference utils_mp.py:21-37). Workers are spawned, not forked: the
    calling process may hold CUDA state and threads."""
    if len(parameters) == 0:
        return []
    num_processes = min(num_processes, len(parameters))
    if num_processes <= 1:
        return [worker_function(*p) for p in parameters]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=num_processes, maxtasksperchild=1) as pool:
        return pool.starmap(worker_function, parameters)


def mp_worker(call: str) -> int:
    """Run a shell command (external tools: Blender/meshlab equivalents,
    reference utils_mp.py:5-18)."""
    try:
        proc = subprocess.run(call, shell=True, check=False)
        return proc.returncode
    except Exception as e:
        print(f"mp_worker failed for call {call!r}: {e}")
        return -1
