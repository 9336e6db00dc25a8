"""The port's spans and counters, in memory, off by default.

``span(name, **attrs)`` is a context manager around a part of the work and
``count(name, n)`` adds to a counter. Names are ``<layer>.<part>``
(``query.extract``, ``write.bytes``). ``blocking(device, n)`` goes around a
call that blocks the host on the card: it counts ``n`` in ``host_syncs`` and
records the call as a ``sync.wait`` span. Off (the default) ``span`` and
``blocking`` return one shared object that does nothing and ``count``
returns at once. ``enable()`` turns recording on, ``take()`` returns what was
recorded and clears it; ``with recording() as got:`` does both around its
body. Nothing here reads a tensor, records a CUDA event or synchronizes the
device.

A span records its id, the id of the span open around it on the same thread
(0 for none), its name, the thread's native id, its start and end on
``time.perf_counter_ns`` and its attributes.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

_on = False
_spans: list[tuple] = []
_counts: dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Null:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _thread()[0]
        self.id = next(_ids)
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack, tid = _thread()
        stack.pop()
        # one append, atomic under the GIL; take() removes only what it read
        _spans.append((self.id, self.parent, self.name, tid, self.t0, t1,
                       self.attrs))
        return False


def _thread() -> tuple[list[int], int]:
    """This thread's stack of open span ids, and its native id."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


def span(name: str, **attrs):
    """A context manager recording ``name`` over its body (while on)."""
    if not _on:
        return NULL
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (while on)."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def blocking(device, n: int = 1):
    """A context manager around a body that blocks the host on ``device``
    ``n`` times (a fetch, a test of a device value, a copy of host memory):
    while on, and only where ``device`` is a CUDA device, the body is
    recorded as a ``sync.wait`` span and ``n`` is added to ``host_syncs``.
    On the CPU nothing waits for a device, and nothing is recorded."""
    if not _on or not str(device).startswith("cuda"):
        return NULL
    count("host_syncs", n)
    return _Span("sync.wait", {})


def count_sizes(name: str, *paths: str) -> None:
    """Add the sizes on disk of the files ``paths`` to ``name`` (while on;
    off, no file is looked at)."""
    if not _on:
        return
    count(name, sum(os.path.getsize(p) for p in paths))


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``take()``."""
    global _on
    _on = False


def take() -> dict:
    """``{"spans": [...], "counters": {...}}``: the spans closed and the
    counters added to since the previous ``take()`` (each span a dict of
    ``id``, ``parent``, ``name``, ``tid``, ``t0_ns``, ``t1_ns`` and
    ``attrs``); clears them. A span still open is returned by a later
    ``take()``."""
    spans = _spans[:]
    del _spans[:len(spans)]
    with _lock:
        counters = dict(_counts)
        _counts.clear()
    keys = ("id", "parent", "name", "tid", "t0_ns", "t1_ns", "attrs")
    return {"spans": [dict(zip(keys, s)) for s in spans],
            "counters": counters}


@contextlib.contextmanager
def recording():
    """Record over the ``with`` body: what was recorded before is dropped,
    and the dict it yields is filled with what ``take()`` returns at the
    body's end."""
    take()
    got: dict = {}
    enable()
    try:
        yield got
    finally:
        disable()
        got.update(take())
