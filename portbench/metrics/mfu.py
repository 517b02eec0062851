"""Model FLOP utilisation, in %: the useful operations of a window's stays
(``portbench/counts/model_flops.py``) over its host-clock seconds, over the
card's bf16 peak. Training reads the measured window; serving the traced
window, whose requests run back to back, so the forward sets its pace."""


def read(ctx):
    if ctx.get("mfu_flops", 0) <= 0 or ctx.get("mfu_s", 0) <= 0:
        return None
    return 100.0 * ctx["mfu_flops"] / ctx["mfu_s"] / ctx["peak_flops"]
