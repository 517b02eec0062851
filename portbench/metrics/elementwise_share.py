"""The elementwise kernels' share of the traced window's kernel time, in %
(the note encoder's poly GELU chain dominates them), by the frozen copy of
the trace report's categories."""
from portbench.counts.categories import category


def read(ctx):
    kernels = ctx.get("kernel_s")
    if not kernels:
        return None
    total = sum(kernels.values())
    return 100.0 * sum(s for n, s in kernels.items() if category(n) == "elementwise") / total
