"""The share of a request's host time spent in the serving layer's own
Python and numpy, in %: the ``serve.assemble`` (records to a host batch) and
``serve.rows`` (calibration, decisions, JSON rows) spans over the
``serve.request`` spans that hold them."""
from portbench.harness import spans


def read(ctx):
    got = spans.under("serve.request")
    if got is None:
        return None
    inside, _ = got
    total = sum(s.host_ms for s in inside if s.name == "serve.request")
    part = sum(s.host_ms for s in inside if s.name in ("serve.assemble", "serve.rows"))
    return 100.0 * part / total if total > 0 else None
