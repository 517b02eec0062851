"""Tracing hooks (counterpart of multimodalrouting_tpu/utils/profiling.py).

* trace_context — a ``torch.profiler`` trace of the enclosed region, written
  as a Chrome trace (open it in Perfetto or chrome://tracing);
* annotate — a named region inside a trace (``record_function``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional


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
