"""The allocator's peak over the measured window
(``torch.cuda.max_memory_allocated``), in GB."""


def read(ctx):
    return ctx["peak_bytes_window"] / 1e9 if ctx.get("peak_bytes_window") else None
