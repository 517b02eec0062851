"""K1's share of its roofline, in %: the bound of every K1 call of the traced
window at its own shape (``portbench/counts``; packed in training) over the profiler's
time of those calls."""
from portbench.counts.categories import K1_FORWARD


def read(ctx):
    ms = 1e3 * sum(s for n, s in ctx.get("kernel_s", {}).items() if K1_FORWARD in n)
    if ms <= 0 or not ctx.get("k1_bound_ms"):
        return None
    return 100.0 * ctx["k1_bound_ms"] / ms
