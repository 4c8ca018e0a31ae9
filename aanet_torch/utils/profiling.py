"""Step timing and traces (own copy of aanet_tpu/utils/profiling.py):

* ``StepTimer``: the seconds of each logging window and the hours left,
  the trainer's ``time %.2fs  ETA %.2fh`` (reference model.py:157-167);
* ``time_fn``: mean seconds a call after warm-up, the device synchronised
  before each clock read (the reference's inference.py:164-175 protocol);
* ``trace``: a ``torch.profiler`` capture of the block into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block (CPU and, where there is one, CUDA activity) and
    write a Chrome trace to ``log_dir/trace.json``; no-op when None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, warmup: int = 10, iters: int = 100) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` (at least one), the device synchronised before each read
    of the clock."""
    for _ in range(max(1, warmup)):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Rolling step timing and ETA over ``total_steps`` (reference
    model.py:157-167)."""

    def __init__(self, total_steps: int):
        self.total_steps = total_steps
        self.last = time.time()
        self.steps_done = 0

    def lap(self, steps: int = 1) -> dict:
        """The window since the last lap, which ran ``steps`` steps: its
        seconds, the seconds a step, and the hours the remaining steps
        take at that rate."""
        now = time.time()
        elapsed = now - self.last
        self.last = now
        self.steps_done += steps
        per_step = elapsed / max(1, steps)
        remaining = max(0, self.total_steps - self.steps_done)
        return {
            "window_seconds": elapsed,
            "seconds_per_step": per_step,
            "eta_hours": per_step * remaining / 3600.0,
        }
