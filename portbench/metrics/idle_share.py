"""The device's idle share of the traced window: the time in which no
kernel ran (the union of the kernels' intervals taken out), in %."""


def read(ctx):
    if "busy_s" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
