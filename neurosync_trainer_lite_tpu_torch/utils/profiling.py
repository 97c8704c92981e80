"""Tracing and step timing (port of
neurosync_trainer_lite_tpu/utils/profiling.py).

- ``profile_trace(log_dir)``: a context manager that records a
  torch.profiler trace of its body (CPU activity, and the card's kernels
  where CUDA is available) and writes it as a chrome trace to
  ``log_dir/trace.json`` on exit, also when the body raises; the training
  CLI's ``--profile DIR`` wraps one epoch in it.
- ``StepTimer``: per-step wall-clock times at little cost. CUDA launches
  return before the card finishes, so a host timestamp per step bounds
  only the launch time; the timer waits for the card every ``sync_every``
  steps, by reading the device scalar it is given (``.item()``), and
  spreads the window's elapsed time evenly over its steps.
- ``span(name)``: a labelled range of the program, recorded only while a
  profiler runs. It lands in the profiler's trace beside the card's
  kernels, on the same clock, so an idle stretch of the card falls inside
  a known span (the benchmark's common/spans.py assigns it to the
  innermost one). The training loop, step and optimizer open them (names
  ``nsync.<group>.<what>``).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


#: what span() returns while no profiler records: one shared context
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """torch.profiler.record_function(name) while a profiler records on
    this thread; otherwise NO_SPAN, at the cost of one flag check."""
    if not torch._C._autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the body with torch.profiler; write log_dir/trace.json. Yields
    the profiler (its key_averages() sums the trace by name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    def __init__(self, sync_every: int = 20):
        self.sync_every = max(1, sync_every)
        self._times: list[float] = []
        self._window_start: float | None = None
        self._window_steps = 0

    def step(self, sync_value=None) -> None:
        """Record one step; pass a device scalar to sync on at the cadence.
        The first call only opens the window."""
        now = time.perf_counter()
        if self._window_start is None:
            self._window_start = now
            return
        self._window_steps += 1
        if self._window_steps % self.sync_every == 0 and sync_value is not None:
            # a CUDA scalar's .item() waits for every launch before it
            torch.as_tensor(sync_value).item()
            elapsed = time.perf_counter() - self._window_start
            per_step = elapsed / self._window_steps
            self._times.extend([per_step] * self._window_steps)
            self._window_start = time.perf_counter()
            self._window_steps = 0

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "steps_per_sec": float(1.0 / t.mean()),
        }
