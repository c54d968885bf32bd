"""The port's tracing: named spans at the program's layer boundaries, a
bounded record of them, and ``trace``, a ``torch.profiler`` capture of the
host and the card exported as a Chrome trace (chrome://tracing, Perfetto).

``annotate(name, allocs=False)`` is the span, as a context manager or a
decorator::

    with annotate("raster.project"):
        ...

    @annotate("lift.first_hit")
    def first_hit(...):
        ...

A span is off unless a torch profiler records or ``enable()`` was called.
Off, ``annotate`` reads the flags and returns the name's shared no-op: it
enters no ``record_function``, allocates nothing and reads no clock (about
0.45 µs with the ``with`` on an H100 machine's host, against 9 µs for a bare
``record_function``). On,
a span

  * enters ``torch.profiler.record_function(name)`` while a profiler records,
    so it lies in the profiler's trace as a ``user_annotation`` event, on the
    device trace's clock;
  * appends a ``Record`` to a bounded buffer (``CAPACITY`` records; past it
    the buffer counts what it drops and does not grow): its name, the span
    around it on the same thread, ``time.perf_counter_ns()`` at its start
    and end, its self time (its duration less its children's) and its
    counts. With ``allocs=True`` the counts hold ``device_mallocs``, the
    CUDA caching allocator's device allocations (``num_device_alloc``) over
    the span, read where CUDA is initialised.

``count(key, value)`` adds to a count of the innermost span that records on
the thread: an int, or a 0-dim tensor, which the record keeps as it is (and
with it the storage it views) until ``records()`` or ``summary()`` reads it,
so a count of a device value waits for nothing inside the span. Without a
recording span, or under ``torch.compile``, it does nothing, at the cost of
an off span.

Spans belong at layer boundaries: never inside an autograd backward
function, nor in a per-tile or per-chunk loop. Under ``torch.compile`` a span
is a ``contextlib.nullcontext`` that the compiler traces through.

Readers: ``records()``, ``summary()``, ``dropped()``; ``reset()`` empties the
buffer. The readers turn the buffer's tensor counts into ints, which waits
for the device once the work that computes them is done.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch.compiler import is_dynamo_compiling as _compiling

CAPACITY = 65_536
_clock = time.perf_counter_ns


class Record(NamedTuple):
    name: str
    parent: Optional[str]      # the enclosing span on the same thread
    start_ns: int              # time.perf_counter_ns()
    end_ns: int
    self_ns: int               # the duration less the enclosed spans'
    counts: Dict[str, int]     # in the buffer, also 0-dim tensors until read


_enabled = False
_records: List[Record] = []
_dropped = 0
_lock = threading.Lock()         # the buffer and the drop count, across threads
_local = threading.local()       # each thread's stack of open spans


def enable() -> None:
    """Turn spans on without a profiler: they record, and enter no
    ``record_function``."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def records() -> List[Record]:
    """The records kept since the process started or the last ``reset()``,
    in the order the spans ended, their counts ints. Tensor counts are read
    here, once: the buffer keeps the ints."""
    with _lock:
        for i, r in enumerate(_records):
            if any(isinstance(v, torch.Tensor) for v in r.counts.values()):
                _records[i] = r._replace(counts={k: int(v) for k, v in r.counts.items()})
        return list(_records)


def dropped() -> int:
    """Records that found the buffer full."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def summary() -> Dict[str, dict]:
    """For each span name: ``calls``, ``total_ms``, ``self_ms`` and the
    summed ``counts``."""
    out: Dict[str, dict] = {}
    for r in records():
        s = out.setdefault(r.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0,
                                    "counts": {}})
        s["calls"] += 1
        s["total_ms"] += (r.end_ns - r.start_ns) * 1e-6
        s["self_ms"] += r.self_ns * 1e-6
        for k, v in r.counts.items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return out


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _device_mallocs() -> Optional[int]:
    if not torch.cuda.is_initialized():
        return None
    # the nested form: ``memory_stats`` flattens and sorts every key, ~0.2 ms
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc")


def _keep(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAPACITY:
            _records.append(rec)
        else:
            _dropped += 1


class _Named:
    """What both kinds of span share: the name, and the decorator form, which
    opens a span at each call."""
    __slots__ = ("name", "allocs")

    def __init__(self, name: str, allocs: bool):
        self.name, self.allocs = name, allocs

    def __call__(self, fn):
        name, allocs = self.name, self.allocs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name, allocs):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Named):
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


class _Span(_Named):
    __slots__ = ("range", "parent", "start", "mallocs", "children_ns", "counts")

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.children_ns = 0
        self.counts = {}
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.mallocs = _device_mallocs() if self.allocs else None
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        _stack().pop()
        dur = end - self.start
        counts = self.counts
        if self.mallocs is not None:
            after = _device_mallocs()
            if after is not None:
                counts["device_mallocs"] = after - self.mallocs
        parent = self.parent
        if parent is not None:
            parent.children_ns += dur
        _keep(Record(self.name, None if parent is None else parent.name, self.start, end,
                     dur - self.children_ns, counts))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


# the shared no-ops, one a name (the decorator form needs the name)
_OFF: tuple = ({}, {})


def annotate(name: str, allocs: bool = False):
    """A named span (module docstring): off, a shared no-op."""
    if _compiling():
        return contextlib.nullcontext()
    if not (_enabled or _profiler._is_profiler_enabled):
        off = _OFF[allocs].get(name)
        if off is None:
            off = _OFF[allocs][name] = _Off(name, allocs)
        return off
    return _Span(name, allocs)


def count(key: str, value) -> None:
    """Add ``value``, an int or a 0-dim tensor, to the count ``key`` of the
    innermost span recording on this thread (module docstring)."""
    if _compiling() or not (_enabled or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[key] = counts[key] + value if key in counts else value


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card where CUDA is available) and write
    its Chrome trace to ``log_dir/trace.json``; the spans opened inside are
    in it. Yields the profiler, whose ``key_averages()`` sums the events by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
