"""Counters and spans of orz_tpu_torch, the program's own instruments.

Counters are plain module ints (``launches`` in each kernel module,
``device.container.segment_retries`` and ``decoder_fallbacks``,
``device.batch.otz1_fallbacks``, ``staged_batches`` and
``staged_segments``, ``device.pcontainer.batch_slots``, ``pad_slots`` and
``short_batches``, ``host_syncs`` here) that readers read and reset as
attributes.  Code adds to them only through ``count``, under one lock:
batches in flight, the mesh's device threads and ``ORZ_PER_SEGMENT``'s
pool add from several threads.

Spans are off until ``start()``.  ``span(name, **attrs)`` then records the
span's name, start and end, its parent, its thread, the ``encode`` span it
belongs to and the number of its ``batch`` span; ``stop()`` turns them off
and returns the records as plain dicts.  While off, ``span`` tests one
module flag and returns the shared no-op ``OFF``: no clock read, no lock,
no span object.  Parents come from a stack per thread; a batch that runs
on another thread names its parent with ``under(current())``.  Nothing
here waits on the device.

Every span is stamped with ``time.time_ns()``, the clock that
``torch.profiler`` stamps its events with (its host operators and, on a
card, the CUDA runtime calls), so that a span lies over the device's
timeline of the same profile.

``sync(site)`` is the span ``sync.<site>`` around a point where the host
waits on the device, and counts it in ``host_syncs`` whether or not spans
are on.
"""

from __future__ import annotations

import itertools
import threading
import time

# Host syncs passed since the last reset: one per ``sync`` site reached
# (device/batch.py, device/pipeline.py, ops/).
host_syncs = 0

_count_lock = threading.Lock()


def count(namespace: dict, name: str = "launches", n: int = 1) -> None:
    """Add `n` to the module counter ``namespace[name]`` (``namespace`` is
    the module's ``globals()``) under one lock: ``x += 1`` on a global can
    lose an update between threads.  Readers read and reset the counter as
    a plain module attribute."""
    with _count_lock:
        namespace[name] += n


class _Off:
    """The span of a run without tracing: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_on = False
_FIELDS = ("name", "start", "end", "id", "parent", "thread", "encode", "batch")
_records: list[tuple] = []  # _FIELDS, then the span's attrs
_records_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_batches = itertools.count()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "encode", "batch", "start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        up = st[-1] if st else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.encode = self.id if self.name == "encode" else (up.encode if up else None)
        self.batch = next(_batches) if self.name == "batch" else (up.batch if up else None)
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        if _on:
            rec = (self.name, self.start, end, self.id, self.parent,
                   threading.get_ident(), self.encode, self.batch, self.attrs)
            with _records_lock:
                _records.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager that records the span `name` (with `attrs`) while
    tracing is on, and the shared ``OFF`` while it is off."""
    if not _on:
        return OFF
    return _Span(name, attrs)


def sync(site: str):
    """The span ``sync.<site>`` around a host sync, counted in
    ``host_syncs``."""
    count(globals(), "host_syncs")
    if not _on:
        return OFF
    return _Span("sync." + site, {})


class _Under:
    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        _stack().append(self.parent)

    def __exit__(self, *exc):
        st = _stack()
        if st and st[-1] is self.parent:
            st.pop()
        return False


def current():
    """This thread's innermost open span (None while tracing is off), for
    ``under`` on another thread."""
    if not _on:
        return None
    st = _stack()
    return st[-1] if st else None


def under(parent):
    """A context manager that makes `parent` (from ``current()`` on another
    thread) the parent of this thread's spans inside it."""
    if parent is None or not _on:
        return OFF
    st = _stack()
    if st and st[-1] is parent:
        return OFF
    return _Under(parent)


def start() -> None:
    """Turn spans on, with no records kept from before."""
    global _on
    with _records_lock:
        _records.clear()
    _on = True


def stop() -> list[dict]:
    """Turn spans off and return the records of the spans that ended since
    ``start()`` (times in ns on ``time.time_ns()``'s clock), in the order
    they ended."""
    global _on
    _on = False
    with _records_lock:
        out = list(_records)
        _records.clear()
    return [dict(zip(_FIELDS, r), **r[-1]) for r in out]
