"""The readers of the program's spans and counters, fed hand-made records:
their values, None where a record is missing, and means per request or
step that a retrace (every record twice) leaves as they were."""
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import tiny  # noqa: F401
from multimodalrouting_tpu_torch.utils import profiling
from portbench.harness import manifest, spans

SERVE = ["notes_ms.serve", "notes_ms.rescore", "pad_share.serve", "pad_share.rescore", "host_share.serve",
         "host_share.rescore"]
TRAIN = ["forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train"]


def rec(name, index, parent, sid, ms, device_ms=None):
    return types.SimpleNamespace(name=name, index=index, parent=parent, sid=sid, host_ms=ms, device_ms=device_ms)


def tree(sid, at, root, children):
    """A root span and its (name, ms, device ms, grandchildren) children,
    indexed from `at`."""
    out = [rec(root[0], at, None, sid, root[1])]
    for name, ms, dev, below in children:
        parent = len(out) + at
        out.append(rec(name, parent, at, sid, ms, dev))
        out += [rec(n, len(out) + at, parent, sid, m) for n, m in below]
    return out


def serve_records():
    one = tree(1, 0, ("serve.request", 100.0), [
        ("serve.assemble", 5.0, None, []), ("serve.queue", 0.1, None, []), ("serve.to_device", 2.0, None, []),
        ("serve.forward", 30.0, None, []), ("model.notes", 20.0, 80.0, []), ("serve.readback", 50.0, None, []),
        ("serve.rows", 3.0, None, []), ("serve.rows", 2.0, None, [])])
    two = tree(2, len(one), ("serve.request", 60.0), [
        ("serve.assemble", 4.0, None, []), ("model.notes", 10.0, 40.0, []), ("serve.rows", 1.0, None, []),
        ("serve.rows", 1.0, None, [])])
    return one + two, {"serve.chunks": 9, "notes.slots": 16}


def train_records():
    one = tree(7, 0, ("train.step", 400.0), [
        ("train.forward", 100.0, None, [("model.notes", 60.0)]), ("train.backward", 200.0, None, []),
        ("train.optimizer", 50.0, None, [("train.sync", 10.0), ("train.sync", 5.0)])])
    two = tree(8, len(one), ("train.step", 330.0), [
        ("train.forward", 80.0, None, []), ("train.backward", 180.0, None, []),
        ("train.optimizer", 40.0, None, [("train.sync", 8.0)])])
    return one + two, {"notes.slots": 40}


WANT = {"notes_ms": (80.0 + 40.0) / 2, "pad_share": 100.0 * (1 - 9 / 16),
        "host_share": 100.0 * (5 + 3 + 2 + 4 + 1 + 1) / (100 + 60),
        "forward_host_ms": 90.0, "backward_host_ms": 190.0, "optimizer_host_ms": ((50.0 - 15.0) + (40.0 - 8.0)) / 2}


def doubled(records):
    """Every record again, as a second try of the traced window leaves them."""
    n = len(records)
    return records + [types.SimpleNamespace(**{**vars(r), "index": r.index + n, "sid": r.sid + 100,
                                               "parent": None if r.parent is None else r.parent + n})
                      for r in records]


def fake(monkeypatch, records, counts):
    monkeypatch.setattr(spans, "program", lambda: types.SimpleNamespace(
        spans=lambda: list(records), counts=lambda: dict(counts), self_ms=profiling.self_ms))


def read(name):
    return manifest.reader(name)({})


@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_values_and_retrace(metric, twice, monkeypatch):
    records, counts = serve_records() if metric in SERVE else train_records()
    if twice:
        records, counts = doubled(records), {k: 2 * v for k, v in counts.items()}
    fake(monkeypatch, records, counts)
    assert read(metric) == pytest.approx(WANT[metric.split(".")[0]])


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_none_where_a_record_is_missing(metric, monkeypatch):
    records, counts = serve_records() if metric in SERVE else train_records()
    monkeypatch.setattr(spans, "program", lambda: None)  # a program without records (the parent's)
    assert read(metric) is None
    fake(monkeypatch, [], {})  # nothing recorded
    assert read(metric) is None
    if metric.startswith(("notes_ms", "host_share")):  # other spans, but no request span
        fake(monkeypatch, [r for r in records if r.name != "serve.request"], counts)
        assert read(metric) is None
    if metric.startswith("notes_ms"):  # no device time (the CPU), or no note encoder span
        fake(monkeypatch, [types.SimpleNamespace(**{**vars(r), "device_ms": None}) for r in records], counts)
        assert read(metric) is None
        fake(monkeypatch, [r for r in records if r.name != "model.notes"], counts)
        assert read(metric) is None
    if metric.startswith("pad_share"):
        fake(monkeypatch, records, {"serve.chunks": 9})
        assert read(metric) is None
        fake(monkeypatch, records, {"notes.slots": 16})
        assert read(metric) is None
    if metric in TRAIN:  # spans of the step, but not the one read
        phase = {"forward": "train.forward", "backward": "train.backward", "optimizer": "train.optimizer"}
        gone = phase[metric.split("_")[0]]
        fake(monkeypatch, [r for r in records if r.name != gone], counts)
        assert read(metric) is None


def test_the_readers_on_the_programs_own_records():
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for chunks in (3, 5):
                with profiling.annotate("serve.request"):
                    with profiling.annotate("serve.assemble"):
                        profiling.count("serve.chunks", chunks)
                    with profiling.annotate("model.notes", device=True):
                        profiling.count("notes.slots", 8)
                    with profiling.annotate("serve.rows"):
                        pass
            with profiling.annotate("train.step"):
                with profiling.annotate("train.optimizer"):
                    with profiling.annotate("train.sync"):
                        pass
        assert read("pad_share.serve") == pytest.approx(50.0)
        assert 0 < read("host_share.serve") < 100
        assert read("notes_ms.serve") is None  # no CUDA events on the CPU
        assert read("optimizer_host_ms.train") >= 0 and read("forward_host_ms.train") is None
    finally:
        profiling.reset()
