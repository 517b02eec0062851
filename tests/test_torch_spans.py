"""The program's spans and counters (``utils/profiling.py``): kept only while
a ``torch.profiler`` session records, nested per thread with one id per
request or step, host-only profiler marks, and placed at the serving
request's, the model's and the train step's layer boundaries."""
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch import serve
from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train.state import create_train_state
from multimodalrouting_tpu_torch.train.steps import make_train_step
from multimodalrouting_tpu_torch.utils import profiling
from multimodalrouting_tpu_torch.utils.profiling import annotate, count, counts, self_ms, spans

# tiny widths (tests/helpers.py's, which imports the JAX package: this file's card test runs where
# there is none); a real-cohort config serves the configured shapes
TINY = {"encoder.d": 32, "encoder.structured_seq_len": 12, "encoder.structured_n_feats": 16,
        "encoder.structured_layers": 1, "encoder.structured_heads": 4, "encoder.bert_hidden": 32,
        "encoder.bert_layers": 1, "encoder.bert_heads": 4, "encoder.bert_intermediate": 64,
        "encoder.bert_vocab_size": 1024, "encoder.bert_max_position": 64, "encoder.text_max_len": 16,
        "encoder.notes_max_chunks": 3, "encoder.image_size": 32, "encoder.vision_backbone": "resnet18",
        "encoder.vision_norm": "group", "model.d": 32, "model.mult_layers": 1, "model.mult_self_layers": 1,
        "model.mult_heads": 4, "model.pc_dim": 8, "model.mc_caps_dim": 16, "model.dtype": "float32",
        "train.batch_size": 4, "data.synthetic": False, "data.data_root": "real-cohort"}
MODEL_SPANS = ["model.labs", "model.notes", "model.image", "model.routes", "model.head"]


@pytest.fixture(autouse=True)
def fresh_records():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_cfg():
    return tc.apply_overrides(tc.Config(), TINY)


def cohort(n: int, chunks):
    """n synthetic stays whose notes hold `chunks[i]` valid chunks."""
    e = tiny_cfg().encoder
    c = make_synthetic_cohort(n, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks,
                              l=e.text_max_len, image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=0)
    mask = (np.arange(e.notes_max_chunks)[None, :] < np.asarray(chunks)[:, None]).astype(np.float32)
    return c._replace(chunk_mask=mask, note_attn=c.note_attn * mask[..., None].astype(c.note_attn.dtype))


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    out = tmp_path_factory.mktemp("spans")
    save_checkpoint(str(out / "final"), model.state_dict(), cfg)
    return serve.Predictor(str(out), device="cpu")


def names_under(root):
    """The names of the spans sharing `root`'s id, in the order they opened."""
    return [s.name for s in spans() if s.sid == root.sid]


def test_nothing_is_recorded_outside_a_profile():
    assert not profiling.recording()
    off = annotate("outer")
    assert annotate("inner", device=True) is off  # no object made per span
    with off as span:
        count("things", 3)
    assert span is None and spans() == [] and counts() == {}
    with cpu_profile():
        assert profiling.recording()
        count("things", 3)
    count("things", 4)
    assert counts() == {"things": 3}


def test_spans_nest_per_thread_share_an_id_and_give_self_time(monkeypatch):
    ticks = iter(range(0, 10**9, 10**6))  # every reading of the clock 1 ms after the last
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(ticks)))

    def on_another_thread():
        with annotate("t"):  # 5, 6
            pass

    with cpu_profile():
        with annotate("a"):  # opens at 0 ms
            with annotate("b"):  # 1
                pass  # 2
            with annotate("c"):  # 3
                with annotate("d"):  # 4
                    th = threading.Thread(target=on_another_thread)
                    th.start()
                    th.join(timeout=30)
                    assert not th.is_alive()
                # 7
            # 8
        # 9
        with annotate("e"):  # 10
            pass  # 11
    recs = spans()
    by = {s.name: s for s in recs}
    assert [s.name for s in recs] == ["a", "b", "c", "d", "t", "e"]
    assert by["a"].parent is None and by["b"].parent == by["c"].parent == by["a"].index
    assert by["d"].parent == by["c"].index and by["t"].parent is None and by["e"].parent is None
    assert by["a"].sid == by["b"].sid == by["c"].sid == by["d"].sid
    assert len({by["a"].sid, by["t"].sid, by["e"].sid}) == 3
    assert [by[n].host_ms for n in "abcdte"] == [9.0, 1.0, 5.0, 3.0, 1.0, 1.0]
    assert self_ms(by["a"], recs) == 9.0 - 1.0 - 5.0
    assert self_ms(by["c"], recs) == 2.0 and self_ms(by["d"], recs) == 3.0  # t is not d's child
    assert by["a"].device_ms is None  # no CUDA events on the CPU


def test_threads_lose_no_span_or_count():
    threads, each = 16, 200

    def work():
        for _ in range(each):
            with annotate("outer"):
                with annotate("inner"):
                    count("n", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    recs = spans()
    assert counts() == {"n": threads * each} and len(recs) == 2 * threads * each
    assert [r.index for r in recs] == list(range(len(recs)))
    by_index = {r.index: r for r in recs}
    for r in recs:  # each inner span sits in an outer span of its own id, opened on its own thread
        if r.name == "inner":
            parent = by_index[r.parent]
            assert parent.name == "outer" and parent.sid == r.sid
    assert len({r.sid for r in recs}) == threads * each


def test_a_span_is_a_cpu_op_and_never_a_user_annotation(tmp_path):
    with cpu_profile() as prof:
        with annotate("mmr.span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with record_function("mmr.user"):
            torch.ones(2).sum()
    events = {e.name: e for e in prof.events()}
    span, user = events["mmr.span"], events["mmr.user"]
    assert span.device_type == DeviceType.CPU and not span.is_user_annotation and span.scope == 0
    assert user.is_user_annotation  # what the profiler mirrors on the device under CUDA activity
    assert any(e.cpu_parent is not None and e.cpu_parent.name == "mmr.span" for e in prof.events())
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"] if e.get("name") == "mmr.span"}
    assert cats == {"cpu_op"}


def test_predict_records_records_the_serving_spans_and_counts(predictor, monkeypatch):
    chunks = [1, 3, 2, 0, 3]
    c = cohort(len(chunks), chunks)
    records = [{"x_struct": c.x_struct[i], "note_ids": c.note_ids[i], "note_attn": c.note_attn[i],
                "chunk_mask": c.chunk_mask[i], "image": c.image[i]} for i in range(len(chunks))]
    monkeypatch.setattr(predictor, "batch_size", 4)  # two slices: two forwards in one request
    with cpu_profile():
        rows = predictor.predict_records(records)
    assert len(rows) == len(chunks)
    (req,) = [s for s in spans() if s.name == "serve.request"]
    forward = ["serve.to_device", "serve.forward"] + MODEL_SPANS + ["serve.readback"]
    assert names_under(req) == (["serve.request", "serve.assemble", "serve.queue"] + forward * 2
                                + ["serve.rows", "serve.rows"])
    assert all(s.parent == req.index for s in spans() if s.name.startswith("serve.") and s is not req)
    assert counts() == {"serve.chunks": sum(chunks),
                        "notes.slots": len(chunks) * predictor.cfg.encoder.notes_max_chunks}
    covered = sum(s.host_ms for s in spans() if s.parent == req.index)
    assert self_ms(req, spans()) == pytest.approx(req.host_ms - covered)


def test_the_http_server_opens_a_request_span_and_keeps_its_400(predictor):
    c = cohort(2, [2, 1])
    body = {"records": [{"x_struct": c.x_struct[i].tolist(), "note_ids": c.note_ids[i].tolist(),
                         "chunk_mask": c.chunk_mask[i].tolist()} for i in range(2)]}
    server = serve.make_http_server(predictor)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        with cpu_profile():
            codes = [post(body), post({"records": []})]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    assert codes == [200, 400] and not th.is_alive()
    ok, bad = [s for s in spans() if s.name == "serve.request"]
    assert names_under(ok)[:3] == ["serve.request", "serve.assemble", "serve.queue"]
    assert names_under(ok)[-1] == "serve.rows" and "model.notes" in names_under(ok)
    assert names_under(bad) == ["serve.request"]
    assert counts() == {"serve.chunks": 3, "notes.slots": 2 * predictor.cfg.encoder.notes_max_chunks}


def test_a_train_step_records_its_phases():
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model = build_model(cfg, "capsule", device="cpu", train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "capsule")
    batch = batch_to(cohort(4, [1, 3, 2, 2]), "cpu")
    gen = torch.Generator().manual_seed(0)
    step(state, batch, gen, 1e-3, 1e-4)  # outside a profile: nothing kept
    assert spans() == []
    with cpu_profile():
        m = step(state, batch, gen, 1e-3, 1e-4)
    assert m.grad_finite
    recs = spans()
    (root,) = [s for s in recs if s.name == "train.step"]
    by = {s.name: s for s in recs}
    assert names_under(root) == (["train.step", "train.forward"] + MODEL_SPANS
                                 + ["train.backward", "train.optimizer", "train.sync", "train.sync"])
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert by[name].parent == root.index
    assert all(s.parent == by["train.optimizer"].index for s in recs if s.name == "train.sync")
    assert all(s.parent == by["train.forward"].index for s in recs if s.name in MODEL_SPANS)
    syncs = sum(s.host_ms for s in recs if s.name == "train.sync")
    assert self_ms(by["train.optimizer"], recs) == pytest.approx(by["train.optimizer"].host_ms - syncs)
    assert counts() == {"notes.slots": 4 * cfg.encoder.notes_max_chunks}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_on_the_card_a_span_leaves_no_device_event_and_times_the_stream(card):
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()  # cuBLAS set up outside the trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with annotate("mmr.card_span", device=True):
            for _ in range(8):
                a = a @ a / 2048
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert device_events and not any("mmr.card_span" in e.name for e in device_events)
    (span,) = spans()
    assert span.device_ms > 0
    host = [e for e in prof.events() if e.name == "mmr.card_span"]
    assert len(host) == 1 and host[0].device_type == DeviceType.CPU
