"""The port's serving artifacts (``multimodalrouting_tpu_torch/artifact.py``)
on the CPU at tiny widths, as the JAX package's tests/test_artifact.py holds
its own: the kernels as custom ops (``torch.library.opcheck``), one
``torch.export`` of a tiny flagship checkpoint whose notes are long enough
for K1 (T = 256) shared by the module, the artifact against the live
Predictor at rtol 1e-6 / atol 1e-7, padding invariance, records and HTTP, a
CPU export that names its platforms, serving in a fresh process in which the
port's models package, JAX and flax cannot be imported, and the refusal of a
JAX artifact directory."""
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.artifact import ExportedPredictor, export_serving_artifact
from multimodalrouting_tpu_torch.ckpt import save_checkpoint
from multimodalrouting_tpu_torch.data.batches import slice_batch
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops.capsule import capsule_weight_init
from multimodalrouting_tpu_torch.serve import Predictor, make_http_server
from tests.helpers import TINY
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-7  # JAX tests/test_artifact.py
# K1's gate needs T >= 256 and a 128-multiple width in heads of 64; a
# real-cohort config serves the full text_max_len (a synthetic one clips it to 128)
K1_TINY = {**TINY, "encoder.bert_hidden": 128, "encoder.bert_heads": 2, "encoder.bert_intermediate": 128,
           "encoder.text_max_len": 256, "encoder.bert_max_position": 256, "encoder.notes_max_chunks": 2,
           "encoder.image_size": 32, "data.synthetic": False, "data.data_root": "real-cohort"}


def cohort(n: int, seed: int):
    return make_synthetic_cohort(n, t=12, f=16, s=2, l=256, image_size=32, vocab_size=1024, seed=seed,
                                 missing_rate=0.25)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded tiny flagship checkpoint (nonzero capsule embedding and bias,
    temperature 1.25, threshold 0.4)."""
    cfg = tc.apply_overrides(tc.Config(), K1_TINY)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model.capsule_head.embedding.copy_(torch.randn(model.capsule_head.embedding.shape, generator=g))
        model.capsule_head.bias.copy_(0.1 * torch.randn(model.capsule_head.bias.shape, generator=g))
    out = str(tmp_path_factory.mktemp("artifact") / "ckpt")
    save_checkpoint(out, model.state_dict(), cfg, temperature=1.25, thresholds=[0.4])
    return out


@pytest.fixture(scope="module")
def predictor(ckpt):
    return Predictor(ckpt, device="cpu")


@pytest.fixture(scope="module")
def artifact_dir(predictor, tmp_path_factory):
    """The module's one export, exported on the CPU for the CPU and the card."""
    out = str(tmp_path_factory.mktemp("artifact") / "art")
    export_serving_artifact(predictor, out, platforms=("cpu", "cuda"))
    return out


@pytest.fixture(scope="module")
def exported(artifact_dir):
    return ExportedPredictor(artifact_dir, device="cpu")


def _op_case(name):
    g = torch.Generator().manual_seed(1)
    if name == "capsule_routing":
        pose, act = torch.randn(5, 10, 32, generator=g), torch.rand(5, 10, generator=g)
        return torch.ops.mmr.capsule_routing.default, (pose, act, capsule_weight_init(10, 32, 2, 64, generator=g), 3)
    q, k, v = (torch.randn(2, 256, 128, generator=g) for _ in range(3))
    m = torch.ones(2, 256)
    m[0, 200:] = 0.0
    m[1] = 0.0
    if name == "packed_attention":
        return torch.ops.mmr.packed_attention.default, (q, k, v, m, 2)
    q4, k4, v4 = (x.unflatten(2, (2, 64)) for x in (q, k, v))
    return torch.ops.mmr.segment_attention.default, (q4, k4, v4, m, name)


@pytest.mark.parametrize("name", ["packed_attention", "flash", "splash", "capsule_routing"])
def test_custom_op_passes_opcheck_on_cpu(name):
    """Each kernel's custom op: schema, fake implementation and AOT dispatch
    (torch.library.opcheck) on CPU tensors, where it runs the plain version."""
    op, args = _op_case(name)
    torch.library.opcheck(op, args)


def test_program_calls_the_kernels_as_custom_ops(artifact_dir, exported, predictor):
    """The exported graph keeps K1 (one per BERT layer) and K3 as the mmr ops,
    so that on the card the program launches them; meta.json has the JAX
    package's schema plus the program and the traced attention branch."""
    targets = [str(n.target) for n in exported._program.graph.nodes if n.op == "call_function"]
    assert targets.count("mmr.packed_attention.default") == predictor.cfg.encoder.bert_layers
    assert targets.count("mmr.capsule_routing.default") == 1
    assert not any("segment_attention" in t for t in targets)
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    assert {"format_version", "family", "task", "routes", "temperature", "thresholds", "batch_size", "platforms",
            "config"} <= set(meta)
    assert (meta["program"], meta["attention"], meta["platforms"], meta["traced_on"]) == (
        "program.pt2", "packed", ["cpu", "cuda"], "cpu")
    assert tc.from_dict(meta["config"]) == predictor.cfg and meta["batch_size"] == predictor.batch_size == 4


def test_exported_matches_live_predictor(predictor, exported):
    batch = cohort(predictor.batch_size, 3)
    live, got = predictor.predict(batch), exported.predict(batch)
    for key in ("probs", "alpha", "r_matrix"):
        np.testing.assert_allclose(got[key], live[key], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["pred"], live["pred"])
    assert exported.temperature == predictor.temperature == 1.25
    assert exported.routes == predictor.routes and exported.family == "capsule"


def test_exported_padding_invariance(exported, predictor):
    """Ragged requests pad to the static batch by a clipped gather without
    leaking pad rows: 3 and 6 records against the rows of full batches."""
    full = cohort(8, 5)
    p_full = exported.predict(full)["probs"]
    for n in (3, 6):
        got = exported.predict(slice_batch(full, 0, n))["probs"]
        assert len(got) == n
        np.testing.assert_allclose(got, p_full[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_full, predictor.predict(full)["probs"], rtol=RTOL, atol=ATOL)


def test_exported_records_and_http(exported):
    rows = exported.predict_records([{"x_struct": np.ones((12, 16))}, {}])
    assert len(rows) == 2 and set(rows[0]["alpha"]) == set(exported.routes)
    server = make_http_server(exported, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        host, port = server.server_address[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["batch_size"] == 4 and health["temperature"] == 1.25
        req = urllib.request.Request(f"http://{host}:{port}/predict", data=json.dumps({"records": [{}]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            preds = json.loads(r.read())["predictions"]
        assert len(preds) == 1 and preds[0]["probs"] == rows[1]["probs"]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def test_served_without_the_models_package_jax_or_flax(artifact_dir, exported):
    """A fresh process in which the port's models package, JAX, flax and the
    JAX package cannot be imported serves the artifact, equal to this one."""
    batch = cohort(4, 7)
    code = f"""
import json, sys
for m in ("multimodalrouting_tpu_torch.models", "jax", "jaxlib", "flax", "multimodalrouting_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from multimodalrouting_tpu_torch.artifact import ExportedPredictor
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort
batch = make_synthetic_cohort(4, t=12, f=16, s=2, l=256, image_size=32, vocab_size=1024, seed=7, missing_rate=0.25)
out = ExportedPredictor({artifact_dir!r}, device="cpu").predict(batch)
print(json.dumps({{k: v.tolist() for k, v in out.items()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    ref = exported.predict(batch)
    for key in ("probs", "alpha", "r_matrix"):
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL)


def test_a_jax_artifact_is_refused(tmp_path):
    """A directory holding the JAX package's StableHLO program is refused,
    naming what serves its checkpoint instead."""
    (tmp_path / "program.jaxexp").write_bytes(b"")
    (tmp_path / "meta.json").write_text(json.dumps({"format_version": 1}))
    with pytest.raises(ValueError, match=r"needs JAX.*cli predict --ckpt"):
        ExportedPredictor(str(tmp_path), device="cpu")


def test_export_refuses_unknown_platforms(predictor, tmp_path):
    with pytest.raises(ValueError, match="platforms are cpu and cuda"):
        export_serving_artifact(predictor, str(tmp_path), platforms=("cpu", "tpu"))
