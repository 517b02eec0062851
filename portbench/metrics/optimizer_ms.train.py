"""The optimizer's device time a step, in ms: the multi-tensor
(``torch._foreach_*``) kernels of ``train/state.py:apply_gradients`` over
the traced steps."""
from portbench.counts.categories import FOREACH


def read(ctx):
    kernels = ctx.get("kernel_s")
    if not kernels or not ctx.get("traced_calls"):
        return None
    s = sum(v for n, v in kernels.items() if any(p in n for p in FOREACH))
    return 1e3 * s / ctx["traced_calls"] if s > 0 else None
