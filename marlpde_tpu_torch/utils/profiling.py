"""Tracing/profiling hooks (port of marlpde_tpu/utils/profiling.py):
torch.profiler traces and a throughput counter.

Usage:
    with trace("/tmp/tb"):          # Chrome trace of host and device activity
        run_generation(...)

    tm = Throughput()
    tm.tick(n_env_steps)            # call per generation
    tm.rate()                       # env-steps/s over the window
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the CPU and, when there is one, the card;
    writes ``<log_dir>/trace.json`` on exit.  A profiler that cannot start
    leaves the block to run unprofiled."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except RuntimeError:
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A labelled region inside traces."""
    return torch.profiler.record_function(name)


class Throughput:
    """Sliding-window steps/s counter."""

    def __init__(self, window: int = 20):
        self.window = window
        self.samples: list[tuple[float, float]] = []

    def tick(self, n_steps: float):
        self.samples.append((time.perf_counter(), float(n_steps)))
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def rate(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        dt = self.samples[-1][0] - self.samples[0][0]
        steps = sum(s for _, s in self.samples[1:])
        return steps / dt if dt > 0 else 0.0
