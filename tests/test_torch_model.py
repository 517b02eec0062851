"""The PyTorch port's slice as a whole against the JAX package on the CPU:
configs, synthetic cohorts, routes, the flagship CapsuleRoutingModel at the
tiny test config, the serving Predictor on a checkpoint made through the
bridge, the HTTP server, and the rule that the port never imports JAX."""
import glob
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jconfigs
from multimodalrouting_tpu import routes as jroutes
from multimodalrouting_tpu import serve as jserve
from multimodalrouting_tpu.data.synthetic import make_synthetic_cohort as jcohort
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu_torch import configs as tconfigs
from multimodalrouting_tpu_torch import routes as troutes
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import load_config, save_checkpoint
from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort as tcohort
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.serve import Predictor, batch_from_records, make_http_server, write_predictions_jsonl
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import assert_close, jitter, t, torch_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "multimodalrouting_tpu_torch")
# tiny flagship with BatchNorm; notes and images at the sizes the serving
# shapes of a synthetic checkpoint keep (L <= 128, image <= 96)
SLICE = {**TINY, "encoder.vision_norm": "batch", "encoder.text_max_len": 16, "encoder.image_size": 32}
OUTPUTS = ("logits", "alpha", "r_matrix", "chexpert_logits")


def _cfgs(**extra):
    over = {**SLICE, **extra}
    return jconfigs.apply_overrides(jconfigs.Config(), over), tconfigs.apply_overrides(tconfigs.Config(), over)


YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
PHENO_YAMLS = [p for p in YAMLS if "pos_weight_clip" in open(p).read()]


@pytest.mark.parametrize("path", [None] + YAMLS)
def test_configs_to_dict_equal(path):
    """The port's config equals the JAX package's field by field, after
    load_cfg and after a round trip through to_dict / from_dict, except at
    train.pos_weight_clip: there the port holds the tuple, and JAX holds the
    string that fault F1 (ROADMAP.md) leaves wherever the value was coerced
    (a YAML that sets it, every round trip)."""
    j = jconfigs.load_cfg(path, environ={})
    p = tconfigs.load_cfg(path, environ={})
    loaded = (tconfigs.to_dict(p), jconfigs.to_dict(j))
    back = (tconfigs.to_dict(tconfigs.from_dict(loaded[0])), jconfigs.to_dict(jconfigs.from_dict(loaded[1])))
    jax_loaded = "[0.1, 5.0]" if path in PHENO_YAMLS else (0.1, 5.0)
    for (tdict, jdict), jax_clip in ((loaded, jax_loaded), (back, str(jax_loaded))):
        assert tdict["train"].pop("pos_weight_clip") == (0.1, 5.0)
        assert jdict["train"].pop("pos_weight_clip") == jax_clip
        assert tdict == jdict


@pytest.mark.parametrize("path", [None] + YAMLS)
def test_config_round_trip_keeps_every_field(path):
    """F1 fixed in the port: from_dict(to_dict(cfg)) == cfg for Config() and
    every YAML, directly and through JSON (a checkpoint's config.json)."""
    cfg = tconfigs.load_cfg(path, environ={})
    assert tconfigs.from_dict(tconfigs.to_dict(cfg)) == cfg
    assert tconfigs.from_dict(json.loads(json.dumps(tconfigs.to_dict(cfg)))) == cfg
    assert cfg.train.pos_weight_clip == (0.1, 5.0)


@pytest.mark.parametrize(
    "source",
    [os.path.basename(p) for p in PHENO_YAMLS] + ["--set 0.1,5.0", "--set (0.1, 5.0)", "env", "checkpoint"],
)
def test_pos_weight_clip_loads_as_a_tuple_of_floats(source, tmp_path):
    if source.endswith(".yaml"):
        cfg = tconfigs.load_cfg(os.path.join(ROOT, "configs", source), environ={})
    elif source.startswith("--set"):
        cfg = tconfigs.load_cfg(None, overrides={"train.pos_weight_clip": source.split(" ", 1)[1]}, environ={})
    elif source == "env":
        cfg = tconfigs.load_cfg(None, environ={"MIMICIV_POS_WEIGHT_CLIP": "0.1,5.0"})
    else:
        pheno = tconfigs.load_cfg(os.path.join(ROOT, "configs", "pheno_25.yaml"), environ={})
        save_checkpoint(str(tmp_path), {}, pheno)
        cfg = load_config(str(tmp_path))
        assert cfg == pheno
    clip = cfg.train.pos_weight_clip
    assert clip == (0.1, 5.0) and isinstance(clip, tuple) and all(isinstance(x, float) for x in clip)


@pytest.mark.parametrize(
    "kw",
    [dict(n=8), dict(n=6, missing_rate=0.3, seed=3), dict(n=5, task="pheno", seed=1),
     dict(n=4, task="multitask", s=8, l=512, image_size=224, t=48, f=76)],
)
def test_synthetic_cohort_bit_identical(kw):
    a, b = jcohort(**kw), tcohort(**kw)
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if x is None:
            assert y is None, name
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_routes_match_jax():
    rng = np.random.default_rng(0)
    has = [(rng.random(9) > 0.4).astype(np.float32) for _ in range(3)]
    for tax in ("7", "10"):
        routes = troutes.get_routes(tax)
        assert routes == jroutes.get_routes(tax)
        assert troutes.get_blocks(routes) == jroutes.get_blocks(routes)
        ref = jroutes.route_mask_from_presence(*(jnp.asarray(h) for h in has), routes)
        assert_close(troutes.route_mask_from_presence(*(t(h) for h in has), routes), ref, rtol=0, atol=0)


def _jax_model(cfg, batch, seed):
    model = jbuild_model(cfg, "capsule")
    variables = jitter(model.init(jax.random.PRNGKey(0), batch, train=False), seed=seed, scale=0.02)
    return model, variables


def _jax_eval(model, variables, batch, cfg):
    rm = jroutes.route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, jroutes.get_routes(cfg.model.routes))
    v = {"params": variables.get("ema_params", variables["params"]), "batch_stats": variables["batch_stats"]}
    return model.apply(v, batch, train=False, route_mask=rm)


@pytest.mark.parametrize("missing_rate", [0.0, 0.3])
def test_capsule_routing_model_matches_jax(missing_rate):
    """Flagship model at the tiny config (BatchNorm with running statistics):
    logits, alpha, r_matrix and CheXpert logits against JAX eval."""
    jcfg, tcfg = _cfgs()
    batch = tiny_batch(n=6, seed=1, missing_rate=missing_rate)
    if missing_rate:
        assert batch.has_n.min() == 0 or batch.has_i.min() == 0
    model, variables = _jax_model(jcfg, batch, seed=11)
    ref = _jax_eval(model, variables, batch, jcfg)
    tmodel = load_jax_variables(build_model(tcfg, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    for name in OUTPUTS:
        assert_close(getattr(got, name), getattr(ref, name), err_msg=name)
    # r_matrix sums to 1 over available routes for every label
    np.testing.assert_allclose(got.r_matrix.sum(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("missing_rate", [0.0, 0.3])
def test_pheno_capsule_routing_model_matches_jax(missing_rate):
    """The 25-phenotype model (configs/pheno_25.yaml: task pheno, 25 label
    capsules, softmax_out routing over them) at the tiny widths: logits,
    alpha, r_matrix and CheXpert logits against JAX eval."""
    path = os.path.join(ROOT, "configs", "pheno_25.yaml")
    jcfg = jconfigs.load_cfg(path, overrides=SLICE, environ={})
    tcfg = tconfigs.load_cfg(path, overrides=SLICE, environ={})
    assert tcfg.model.task == "pheno" and tcfg.model.num_classes == 25
    batch = tiny_batch(n=5, seed=4, task="pheno", missing_rate=missing_rate)
    model, variables = _jax_model(jcfg, batch, seed=21)
    ref = _jax_eval(model, variables, batch, jcfg)
    tmodel = load_jax_variables(build_model(tcfg, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    assert tuple(got.logits.shape) == (5, 25) and tuple(got.r_matrix.shape) == (5, 10, 25)
    for name in OUTPUTS:
        assert_close(getattr(got, name), getattr(ref, name), err_msg=name)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port checkpoint bridged from JAX variables with an EMA that differs
    from the raw params, a non-unit temperature and a threshold."""
    jcfg, tcfg = _cfgs()
    batch = tiny_batch(n=4, seed=2)
    model, variables = _jax_model(jcfg, batch, seed=12)
    variables["ema_params"] = jitter({"params": variables["params"]}, seed=13, scale=0.01)["params"]
    tmodel = build_model(tcfg, device="cpu")
    ckpt = str(tmp_path_factory.mktemp("torch_serve") / "ckpt")
    save_checkpoint(ckpt, state_dict_from_jax(variables, tmodel), tcfg, temperature=1.3, thresholds=[0.45])
    return dict(ckpt=ckpt, jcfg=jcfg, model=model, variables=variables, predictor=Predictor(ckpt, device="cpu"))


def _records(n, seed, drop_image=()):
    c = tiny_batch(n=n, seed=seed)
    recs = []
    for i in range(n):
        r = {"x_struct": c.x_struct[i], "m_struct": c.m_struct[i], "note_ids": c.note_ids[i],
             "note_attn": c.note_attn[i], "chunk_mask": c.chunk_mask[i]}
        if i not in drop_image:
            r["image"] = c.image[i]
        recs.append(r)
    return recs


def test_predictor_matches_jax_eval(served):
    """probs (death-logit contrast, temperature 1.3), pred (threshold 0.45),
    alpha and r_matrix of the port Predictor == the JAX model's eval outputs
    with the EMA weights, on records missing an image or notes."""
    recs = _records(6, seed=3, drop_image=(1,))
    recs[4].pop("note_ids")
    jbatch = jserve.batch_from_records(served["jcfg"], recs)
    ref = _jax_eval(served["model"], served["variables"], jbatch, served["jcfg"])
    probs = jserve.calibrate_probs(jserve.probs_from_logits(np.asarray(ref.logits), "mort"), 1.3)
    pred = served["predictor"]
    pred.batch_size = 4  # two slices: 4 + 2 rows
    tbatch = batch_from_records(pred.cfg, recs)
    assert tbatch.has_i[1] == 0 and tbatch.has_n[4] == 0
    out = pred.predict(tbatch)
    assert_close(out["probs"], probs)
    np.testing.assert_array_equal(out["pred"], jserve.decide(probs, np.asarray([0.45])))
    assert_close(out["alpha"], ref.alpha)
    assert_close(out["r_matrix"], ref.r_matrix)
    rows = pred.predict_records(recs)
    assert rows[1]["alpha"]["I"] == 0.0 and len(rows[0]["top_routes"]) == 3
    assert rows == jserve.rows_from_output(out, 6, pred.routes, 1.3)


def test_http_server_roundtrip(served):
    pred = served["predictor"]
    server = make_http_server(pred, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        base = "http://%s:%d" % server.server_address[:2]
        recs = _records(2, seed=4, drop_image=(1,))
        body = json.dumps({"records": [{k: np.asarray(v).tolist() for k, v in r.items()} for r in recs]}).encode()
        req = urllib.request.Request(f"{base}/predict", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["predictions"]
        want = json.loads(json.dumps(pred.predict_records(recs)))
        assert len(got) == 2 and got[1]["alpha"]["I"] == 0.0
        for g, w in zip(got, want):
            assert g["pred"] == w["pred"] and g["top_routes"] == w["top_routes"]
            np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-6)
        with urllib.request.urlopen(f"{base}/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["routes"] == pred.routes and health["temperature"] == 1.3
        bad = urllib.request.Request(f"{base}/predict", data=b"{}", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def test_write_predictions_jsonl(served, tmp_path):
    pred = served["predictor"]
    batch = batch_from_records(pred.cfg, _records(3, seed=5))
    path = str(tmp_path / "preds.jsonl")
    assert write_predictions_jsonl(pred, batch, path, stay_ids=np.arange(3) + 100) == 3
    rows = [json.loads(line) for line in open(path)]
    assert [r["stay_id"] for r in rows] == [100, 101, 102] and all(len(r["top_routes"]) == 3 for r in rows)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tcfg)


@pytest.mark.parametrize(
    "over",
    [{"model.routes": "10", "model.bi_fusion_mode": "mult", "model.task": "pheno", "model.num_classes": 25},
     {"model.bi_fusion_mode": "mult"}],
)
def test_per_route_mult_branch_builds(over):
    """The 10-route per-route MulT branch (models/route_mult.py) builds and
    serves every route."""
    _, tcfg = _cfgs(**over)
    model = build_model(tcfg, device="cpu")
    with torch.no_grad():
        out = model(torch_batch(tiny_batch(n=3, seed=1, task=tcfg.model.task)))
    assert sorted(out.route_embs) == sorted(troutes.get_routes("10")) and tuple(out.alpha.shape) == (3, 10)
    assert tuple(out.logits.shape) == (3, tcfg.model.num_classes)


@pytest.mark.parametrize("over", [{"encoder.vision_backbone": "densenet121"}, {"encoder.int8_text": True}])
def test_unported_branches_raise(over):
    """The branches that raised naming ROADMAP.md until they were ported now
    build and serve: DenseNet-121 and the int8 BERT body
    (ops/quant.py, every BERT matmul a QuantDense; tests/test_torch_quant.py
    holds it against the JAX package)."""
    from multimodalrouting_tpu_torch.ops.quant import QuantDense

    _, tcfg = _cfgs(**over)
    model = build_model(tcfg, device="cpu")
    with torch.no_grad():
        out = model(torch_batch(tiny_batch(n=2, seed=1)))
    assert tuple(out.logits.shape) == (2, 2) and torch.isfinite(out.logits).all()
    if over.get("encoder.vision_backbone") == "densenet121":
        assert model.encoders.imgenc.backbone.out_channels == 1024
    else:
        layer = model.encoders.bbert.bert.layer_0
        assert all(isinstance(m, QuantDense) for m in (layer.intermediate, layer.output, layer.attention.attn.q_proj))


def test_bridge_checks_coverage(served):
    variables = served["variables"]
    params = dict(variables["params"])
    params["capsule_head"] = {k: v for k, v in params["capsule_head"].items() if k != "w"}
    tmodel = build_model(_cfgs()[1], device="cpu")
    with pytest.raises(KeyError, match="capsule_head.w"):
        state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]}, tmodel)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|msgpack|ml_dtypes|multimodalrouting_tpu)(\.|\s|$)",
                        re.M)
    sources = glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    for path in sources:
        with open(path) as f:
            hits = banned.findall(f.read())
        assert not hits, f"{path} imports {hits}"
    modules = sorted(
        "multimodalrouting_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".").replace(".__init__", "")
        for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    )
    code = "import json, sys\n" + "".join(f"import {m}\n" for m in modules) + "print(json.dumps(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "msgpack", "ml_dtypes",
                                                     "multimodalrouting_tpu")]
    assert not bad, bad
