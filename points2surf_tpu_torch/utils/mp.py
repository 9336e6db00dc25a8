"""Process-pool fan-out for the host stages (counterpart of
``points2surf_tpu/utils/mp.py``; reference source/base/utils_mp.py). The
metrics' mesh comparisons use it."""

from __future__ import annotations

import multiprocessing


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
