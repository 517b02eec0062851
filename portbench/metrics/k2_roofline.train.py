"""K2's share of its roofline, in %: the bound of every K2 call (di, dq and
dk/dv together) of the traced window at its own packed shape over the
profiler's time of its three kernels."""
from portbench.counts.categories import K2_PARTS


def read(ctx):
    ms = 1e3 * sum(s for n, s in ctx.get("kernel_s", {}).items() if any(p in n for p in K2_PARTS))
    if ms <= 0 or not ctx.get("k2_bound_ms"):
        return None
    return 100.0 * ctx["k2_bound_ms"] / ms
