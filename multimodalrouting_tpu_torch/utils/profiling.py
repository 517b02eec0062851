"""Tracing hooks (counterpart of multimodalrouting_tpu/utils/profiling.py).

* trace_context — a ``torch.profiler`` trace of the enclosed region, written
  as a Chrome trace (open it in Perfetto or chrome://tracing);
* annotate — a named region inside a trace (``record_function``);
* StepTimer — per-step host wall-clock times with a percentile summary
  (a caller that times CUDA work synchronises the device itself).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], cuda: bool = True):
    """Profile the enclosed region into ``log_dir/trace_<pid>.json`` (no-op
    if `log_dir` is None): CPU and CUDA activity, or the CPU alone when
    `cuda` is false (a run on the CPU)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """Wall-clock step timing with streaming percentiles: ``with timer:``
    around each step; the first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "p99_s": float(np.percentile(t, 99)),
            "total_s": float(t.sum()),
        }
