"""``Predictor.warmup`` of the port (fault F5 in ROADMAP.md §3): it exists,
runs one serving forward through the kernels' plain versions on the CPU, as
many of them as a real request's forward, and ``cli predict --port`` calls
it before the server starts, as the JAX CLI does (cli.py:378-379)."""
import pytest
import torch

from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch import serve
from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import flash_packed, fused_capsule
from tests.helpers import TINY
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# K1's gate needs T >= 256 and a 128-multiple width in heads of 64; a
# real-cohort config serves the full text_max_len (a synthetic one clips it to 128)
K1_TINY = {**TINY, "encoder.bert_hidden": 128, "encoder.bert_heads": 2, "encoder.bert_intermediate": 128,
           "encoder.bert_layers": 2, "encoder.text_max_len": 256, "encoder.bert_max_position": 256,
           "encoder.notes_max_chunks": 2, "encoder.image_size": 32, "data.synthetic": False,
           "data.data_root": "real-cohort"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = tc.apply_overrides(tc.Config(), K1_TINY)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    out = tmp_path_factory.mktemp("warmup")
    save_checkpoint(str(out / "final"), model.state_dict(), cfg)  # the CLI's default --name
    return str(out)


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of K1's and K3's plain versions, the CPU's stand-ins for the kernels."""
    calls = {"K1": 0, "K3": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(flash_packed, "packed_attention_reference",
                        counted("K1", flash_packed.packed_attention_reference))
    monkeypatch.setattr(fused_capsule, "capsule_routing_reference",
                        counted("K3", fused_capsule.capsule_routing_reference))
    return calls


def test_warmup_runs_one_forward_through_the_plain_versions(ckpt, plain_calls, monkeypatch):
    pred = serve.Predictor(ckpt, device="cpu")
    forwards = []
    forward = pred.forward
    monkeypatch.setattr(pred, "forward", lambda b: forwards.append(b.batch_size) or forward(b))
    pred.warmup()
    assert forwards == [1]
    assert plain_calls == {"K1": pred.cfg.encoder.bert_layers, "K3": 1}
    # a real record's request runs the same plain versions as often
    e = pred.cfg.encoder
    c = make_synthetic_cohort(1, t=e.structured_seq_len, f=e.structured_n_feats, s=e.notes_max_chunks,
                              l=e.text_max_len, image_size=e.image_size, vocab_size=e.bert_vocab_size, seed=0)
    record = {"x_struct": c.x_struct[0], "note_ids": c.note_ids[0], "image": c.image[0]}
    rows = pred.predict_records([record])
    assert len(rows) == 1 and len(rows[0]["alpha"]) == 10
    assert plain_calls == {"K1": 2 * e.bert_layers, "K3": 2}


def test_cli_predict_port_warms_up_before_serving(ckpt, monkeypatch):
    order = []

    class Stop(Exception):
        pass

    def server(pred, port=0, host="127.0.0.1"):
        order.append("server")
        raise Stop

    monkeypatch.setattr(serve.Predictor, "warmup", lambda self: order.append("warmup"))
    monkeypatch.setattr(serve, "make_http_server", server)
    with pytest.raises(Stop):
        tcli.main(["predict", "--ckpt", ckpt, "--port", "0", "--device", "cpu"])
    assert order == ["warmup", "server"]
