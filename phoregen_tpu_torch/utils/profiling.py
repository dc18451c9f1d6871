"""Profiling hooks: torch.profiler traces and per-step timing.

Counterpart of `phoregen_tpu/utils/profiling.py`: wrap a region in
`profile_trace(logdir)` and load the Chrome trace it writes
(`<logdir>/trace.json`) in Perfetto or chrome://tracing; `StepTimer` times
steps on the host clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Capture a torch.profiler trace of the enclosed region into
    `<logdir>/trace.json`: host activity, and the card's kernels when
    CUDA is available."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


def _sync() -> None:
    """Wait for the card when this process uses one: PyTorch's launches
    return before the device finishes."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock step timing with warmup skip and simple stats. Each
    step ends in a synchronize of the CUDA device when one is in use."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip_first:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": 0.0, "min_s": 0.0, "steps": 0}
        return {"mean_s": sum(self.times) / len(self.times),
                "min_s": min(self.times), "steps": len(self.times)}
