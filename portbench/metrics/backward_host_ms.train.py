"""The host ms a train step spends in ``loss.backward()``: the
``train.backward`` spans of the traced window's ``train.step`` spans, over
their number."""
from portbench.harness import spans


def read(ctx):
    return spans.host_ms_per_root("train.step", "train.backward")
