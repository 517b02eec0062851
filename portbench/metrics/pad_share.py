"""The share of the note encoder's chunk slots that hold no chunk, in %:
1 - the valid chunks of the traced requests (counter ``serve.chunks``, from
the host's chunk mask) over the rows BERT ran (counter ``notes.slots``,
from the shape)."""
from portbench.harness import spans


def read(ctx):
    prof = spans.program()
    if prof is None:
        return None
    c = prof.counts()
    if not c.get("notes.slots") or "serve.chunks" not in c:
        return None
    return 100.0 * (1.0 - c["serve.chunks"] / c["notes.slots"])
