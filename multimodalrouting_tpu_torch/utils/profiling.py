"""Tracing hooks (counterpart of multimodalrouting_tpu/utils/profiling.py).

* trace_context — a ``torch.profiler`` trace of the enclosed region, written
  as a Chrome trace (open it in Perfetto or chrome://tracing);
* annotate — the program's span: a named region inside a trace and, while a
  ``torch.profiler`` session records, a record kept in memory (``spans``);
* count — a counter kept under the same rule (``counts``);
* StepTimer — per-step host wall-clock times with a percentile summary
  (a caller that times CUDA work synchronises the device itself).

A span is a host-only profiler mark: a plain ``cpu_op`` event, never a user
annotation, so the profiler writes no device-side mark for it and a trace's
kernels stay kernels. It shares the profiler's clock with the kernels, so an
idle stretch of the device can be put down to the span the host was in.
While no profile records, a span or a count costs one check of the
profiler's flag: no record, no event, no synchronisation. Records add up
over every profile taken in the process until ``reset``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler


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


class Span:
    """One recorded span: its `name`; its `index` in the records; `parent`,
    the index of the span open around it on its thread (None at the top);
    `sid`, the id that the outermost span open on its thread started, which
    every span of one request or step shares; host ``time.perf_counter_ns``
    at `start_ns` and `end_ns`."""

    __slots__ = ("name", "index", "parent", "sid", "start_ns", "end_ns", "events")

    def __init__(self, name: str, index: int, parent: Optional[int], sid: int, start_ns: int = 0,
                 end_ns: Optional[int] = None, events=None):
        self.name, self.index, self.parent, self.sid = name, index, parent, sid
        self.start_ns, self.end_ns, self.events = start_ns, end_ns, events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The time the current stream took between the span's two CUDA
        events (a span opened with ``device=True`` while CUDA was in use),
        waiting for the second; None for a span without them."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


_SPANS: List[Span] = []
_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()
_THREAD = threading.local()  # each thread's stack of open spans
_IDS = itertools.count(1)


class _Off:
    """The span while no profile records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorded:
    __slots__ = ("span", "mark", "stack")

    def __init__(self, name: str, device: bool):
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        parent = stack[-1] if stack else None
        with _LOCK:
            sid = parent.sid if parent is not None else next(_IDS)
            span = Span(name, len(_SPANS), None if parent is None else parent.index, sid)
            _SPANS.append(span)
        if device and torch.cuda.is_initialized():
            span.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.span, self.stack = span, stack
        self.mark = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self) -> Span:
        span = self.span
        self.stack.append(span)
        self.mark.__enter__()
        if span.events is not None:
            span.events[0].record()
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record()
        self.mark.__exit__(*exc)
        self.stack.pop()
        return False


def recording() -> bool:
    """Whether a ``torch.profiler`` session records: spans and counts are
    kept then and only then."""
    return _profiler._is_profiler_enabled


def annotate(name: str, device: bool = False):
    """``with annotate(name):`` the program's span of the enclosed region.
    With `device`, the span also times the current CUDA stream between its
    ends (two CUDA events, read only by ``Span.device_ms``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, device)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a profile records."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def spans() -> List[Span]:
    """The closed spans recorded so far, in the order they opened."""
    with _LOCK:
        return [s for s in _SPANS if s.end_ns is not None]


def counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def self_ms(span: Span, records: List[Span]) -> float:
    """The span's host ms less the part its children among `records` cover
    (the children of one span ran one after another on its thread)."""
    return span.host_ms - sum(r.host_ms for r in records if r.parent == span.index)


def reset() -> None:
    """Forget every span and count recorded so far."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


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
