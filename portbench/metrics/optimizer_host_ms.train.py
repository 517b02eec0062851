"""The optimizer's own host ms a train step: each ``train.optimizer`` span
(``train/state.py:apply_gradients``) less the part its children cover,
the ``train.sync`` spans in which the host waits on the card to read the
finite check and the clip, over the traced window's ``train.step`` spans."""
from portbench.harness import spans


def read(ctx):
    got = spans.under("train.step")
    if got is None:
        return None
    inside, n = got
    own = [spans.program().self_ms(s, inside) for s in inside if s.name == "train.optimizer"]
    return sum(own) / n if own else None
