"""The traced window: ``torch.profiler`` over a fixed number of calls, read
back as kernel intervals and host ops.

The window is a ``record_function`` span ("portbench.window") around the
calls and the closing synchronisation; its length in the profiler's own
clock is ``window_s``. ``busy_s`` is the union of the kernels' intervals
inside it (two kernels on two streams at once count once). Each idle gap
between kernels is named by the innermost host op running at its start.
A trace whose K1 or K3 launches differ from the program's counters lost
events and is taken again (``scripts/torch_trace_report.py``'s rule, at
most three times).
"""
from __future__ import annotations

import collections
import heapq
from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "portbench.window"
TRIES = 3
HELD = (("attention_fwd_wgmma_kernel", "K1"), ("capsule_routing_kernel", "K3"))

Interval = Tuple[str, float, float]  # name, start us, end us


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(kernels: Sequence[Interval], w_start: float, w_end: float) -> List[Tuple[float, float]]:
    """The idle stretches of the window: no kernel running."""
    out, at = [], w_start
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if w_end > at:
        out.append((at, w_end))
    return out


def name_gaps(idle: Sequence[Tuple[float, float]], host_ops: Sequence[Interval]) -> Dict[str, float]:
    """Idle seconds by the innermost host op running at each gap's start."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    ops = sorted(host_ops, key=lambda o: o[1])
    heap: List[Tuple[float, float, str]] = []  # (-start, end, name): the latest-started op on top
    i = 0
    for s, e in sorted(idle):
        while i < len(ops) and ops[i][1] <= s:
            heapq.heappush(heap, (-ops[i][1], ops[i][2], ops[i][0]))
            i += 1
        while heap and heap[0][1] < s:  # ended before this gap, and before every later one
            heapq.heappop(heap)
        by_name[heap[0][2] if heap else "host (no op recorded)"] += (e - s) / 1e6
    return dict(by_name)


def summarize(kernels: Sequence[Interval], host_ops: Sequence[Interval], w_start: float, w_end: float) -> Dict:
    inside = [(n, max(s, w_start), min(e, w_end)) for n, s, e in kernels if e > w_start and s < w_end]
    busy = union_us([(s, e) for _, s, e in inside])
    per_op: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in inside:
        per_op[n] += (e - s) / 1e6
    idle = name_gaps(gaps(inside, w_start, w_end), host_ops)
    return {
        "window_s": (w_end - w_start) / 1e6, "busy_s": busy / 1e6, "kernel_s": per_op,
        "idle_by_host_op": idle,
    }


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def traced_window(run_once: Callable[[int], None], calls: int, counters: Callable[[], Dict[str, int]],
                  sync: Callable[[], None]) -> Dict:
    """`calls` calls of ``run_once(i)`` under the profiler -> the summary, the
    kernel intervals and the launches counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(TRIES):
        before = counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for i in range(calls):
                    run_once(i)
                sync()
        after = counters()
        events = prof.events()
        kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name != WINDOW]  # the span's own device-side mark
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU and e.name != WINDOW]
        win = [e for e in events if e.name == WINDOW]
        if not kernels or not win:
            raise RuntimeError("the trace holds no device kernel or no window span: the profiler recorded no CUDA "
                               "activity")
        counted = {k: after[k] - before[k] for _, k in HELD}
        traced = {k: sum(1 for n, _, _ in kernels if pattern in n) for pattern, k in HELD}
        if traced == counted:
            break
        print(f"[trace] launches in the trace {traced}, counted {counted}: events lost, tracing again "
              f"({attempt + 1} of {TRIES})", flush=True)
    else:
        raise RuntimeError(f"the trace holds {traced} launches where the counters read {counted}, {TRIES} times")
    w = win[0].time_range
    out = summarize(kernels, host, w.start, w.end)
    out["launches"] = counted
    return out
