"""The note encoder's device time a request, in ms: the CUDA stream's time
between the two events of each ``model.notes`` span (``models/full.py``,
BERT over the request's chunk slots, projected and pooled) in the traced
window's ``serve.request`` spans, over their number."""
from portbench.harness import spans


def read(ctx):
    got = spans.under("serve.request")
    if got is None:
        return None
    inside, n = got
    ms = [s.device_ms for s in inside if s.name == "model.notes"]
    if not ms or None in ms:
        return None
    return sum(ms) / n
