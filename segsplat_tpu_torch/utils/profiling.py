"""Timing and tracing helpers (the counterpart of
segsplat_tpu/utils/profiling.py, after the reference's per-iteration CUDA event
timing, train_unified_lift.py:310-311,431): ``StepTimer``, a host-side step
timer with an EMA (the tqdm postfix); ``timed``, a block timer; ``trace``, a
``torch.profiler`` capture of the host and the card exported as a Chrome trace
(chrome://tracing, Perfetto); ``annotate``, a named range inside a trace.

The host timers measure what the host waits for: end a timed block that
launches work on the card with ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


class StepTimer:
    """EMA step timer (the reference logs iter_time to wandb, :522)."""

    def __init__(self, ema: float = 0.6):
        self.ema = ema
        self.value: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.value = dt if self.value is None else (
            self.ema * self.value + (1 - self.ema) * dt)
        return False

    @property
    def ms(self) -> float:
        return (self.value or 0.0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card where CUDA is available) and write
    its Chrome trace to ``log_dir/trace.json``. Yields the profiler, whose
    ``key_averages()`` sums the events by name."""
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


def annotate(name: str) -> torch.profiler.record_function:
    """A named range inside an active trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Block timer: appends the seconds to ``results[label]`` when given, else
    prints the milliseconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results.setdefault(label, []).append(dt)
        else:
            print(f"[{label}] {dt * 1e3:.1f} ms")
