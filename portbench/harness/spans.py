"""The program's own spans and counters (``utils/profiling.py``), as a
traced window leaves them.

The program keeps them only while the profiler records, so they cover the
traced window's calls, every try of it where the trace was taken again:
each reader gives a mean per request or step, or a ratio, which a retrace
leaves as it was. A program that keeps no such records gives None, and the
metrics that read them are left out of its result line.
"""
from __future__ import annotations


def program():
    """The program's profiling module where it keeps span records, else None."""
    from multimodalrouting_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def under(root: str):
    """-> (the spans that share the id of a `root` span, the number of
    `root` spans), or None where no `root` span was recorded."""
    prof = program()
    if prof is None:
        return None
    records = prof.spans()
    roots = [s for s in records if s.name == root]
    if not roots:
        return None
    ids = {s.sid for s in roots}
    return [s for s in records if s.sid in ids], len(roots)


def host_ms_per_root(root: str, name: str):
    """The host ms of the `name` spans in a `root` span, a `root` span."""
    got = under(root)
    if got is None:
        return None
    inside, n = got
    ms = [s.host_ms for s in inside if s.name == name]
    return sum(ms) / n if ms else None
