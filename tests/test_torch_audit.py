"""The port's copies of the JAX package's numpy audit modules (fairness, the
drop table, the route heatmap tables and reliability diagram) against the
originals, the train-state checkpoint (``ckpt.restore_train_state``) and
the profiler hook."""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import cli as jcli
from multimodalrouting_tpu import configs as jconfigs
from multimodalrouting_tpu.audit import attribution as jattr
from multimodalrouting_tpu.audit import droptable as jdrop
from multimodalrouting_tpu.audit import exports as jexports
from multimodalrouting_tpu.audit import probes as jprobes
from multimodalrouting_tpu.audit import sweep as jsweep
from multimodalrouting_tpu.ckpt import save_checkpoint as jsave_checkpoint
from multimodalrouting_tpu.data.batches import Batch as JBatch
from multimodalrouting_tpu.metrics import fairness as jfair
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.routes import get_routes as jget_routes
from multimodalrouting_tpu.routes import route_mask_from_presence as jroute_mask
from multimodalrouting_tpu.train.state import create_train_state as jcreate_train_state
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.audit import attribution as tattr
from multimodalrouting_tpu_torch.audit import droptable as tdrop
from multimodalrouting_tpu_torch.audit import exports as texports
from multimodalrouting_tpu_torch.audit import probes as tprobes
from multimodalrouting_tpu_torch.audit import sweep as tsweep
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.ckpt import TRAIN_STATE, load_meta, restore_train_state, save_checkpoint
from multimodalrouting_tpu_torch.data.batches import Batch as TBatch
from multimodalrouting_tpu_torch.metrics import fairness as tfair
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.routes import ROUTES_7, route_mask_from_presence
from multimodalrouting_tpu_torch.routes import get_routes as tget_routes
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict, train_state_dict
from multimodalrouting_tpu_torch.utils.profiling import annotate, trace_context
from tests.helpers import TINY, tiny_batch
from tests.test_torch_cli import TINY_SETS, _random_variables, _template_init
from tests.test_torch_cli import run as run_cli
from tests.torch_parity import compiled, jitter, torch_batch

FAIR_TOL = 1e-12
FILE_TOL = 1e-7


def _fair_inputs(seed: int, n: int = 97, groups: int = 3):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(np.float32)
    prob = rng.random(n)
    return y, prob, rng.integers(0, groups, n), (prob > 0.4).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["eddi", "equalized_odds_gap", "predictive_parity_gap", "equalized_odds_suite",
                                "eddi_subgroups", "group_fairness_metrics", "fairness_report"])
def test_fairness_copy_matches_jax(fn, seed):
    y, prob, groups, pred = _fair_inputs(seed)
    args = {
        "eddi": (y, prob, groups), "equalized_odds_gap": (y, pred, groups),
        "predictive_parity_gap": (y, pred, groups), "equalized_odds_suite": (groups, y, pred),
        "eddi_subgroups": (groups, y, prob, 0.4), "group_fairness_metrics": (groups, y, pred),
        "fairness_report": ({"a": groups, "b": groups % 2}, y, prob, 0.4),
    }[fn]
    got, ref = getattr(tfair, fn)(*args), getattr(jfair, fn)(*args)

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(flat(v) for v in x)
        return pytest.approx(x, abs=FAIR_TOL, nan_ok=True)

    assert got == flat(ref)
    assert tfair.combined_eddi(0.1, 0.3) == jfair.combined_eddi(0.1, 0.3)


def _predict(b):
    """A deterministic probability from the presence flags and the labs."""
    x = np.asarray(b.x_struct).mean(axis=(1, 2))
    z = 2.0 * np.asarray(b.has_l) * x + 0.7 * np.asarray(b.has_n) - 0.4 * np.asarray(b.has_i) + np.asarray(b.m_struct)[:, 0]
    p = 1.0 / (1.0 + np.exp(-(z - 1.0)))
    return p if np.asarray(b.y).ndim == 1 else np.stack([p, 1 - p, p * p], axis=1)


@pytest.mark.parametrize("task, thresholds", [("mort", None), ("mort", [0.45]), ("multitask", None),
                                              ("multitask", [0.3, 0.5, 0.6])])
def test_drop_table_copy_matches_jax(task, thresholds):
    cohort = tiny_batch(n=40, seed=7, task=task, missing_rate=0.2)
    th = None if thresholds is None else np.asarray(thresholds)
    ref = jdrop.drop_table_eval(_predict, JBatch(*cohort), seed=3, thresholds=th)
    got = tdrop.drop_table_eval(_predict, TBatch(*cohort), seed=3, thresholds=th)
    assert list(got) == list(ref)
    for cond in ref:
        assert got[cond] == pytest.approx(ref[cond], abs=1e-12, nan_ok=True), cond
    assert tdrop.format_drop_table(got) == jdrop.format_drop_table(ref)


def _split(obj):
    """(obj with every number replaced by None, the numbers in order)."""
    nums = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            nums.append(float(x))
            return None
        return x

    return walk(obj), np.asarray(nums)


def _files(root):
    return sorted(os.listdir(root))


def _compare_dirs(jdir, tdir):
    names = _files(jdir)
    assert names == _files(tdir)
    for name in names:
        jp, tp = os.path.join(jdir, name), os.path.join(tdir, name)
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(tp), np.load(jp), rtol=0, atol=FILE_TOL, err_msg=name)
        elif name.endswith(".json"):
            with open(jp) as f, open(tp) as g:
                (ref_shape, ref), (got_shape, got) = _split(json.load(f)), _split(json.load(g))
            assert got_shape == ref_shape, name
            np.testing.assert_allclose(got, ref, rtol=0, atol=FILE_TOL, err_msg=name)
        elif name.endswith(".csv"):
            with open(jp) as f, open(tp) as g:
                assert g.read() == f.read(), name
    return names


@pytest.mark.parametrize("k", [1, 25])
def test_route_heatmap_tables_copy_writes_the_same_files(k, tmp_path):
    rng = np.random.default_rng(k)
    routes = ["L", "N", "I", "LN", "NL", "LI", "IL", "NI", "IN", "LNI"]
    alpha = rng.random((13, 10))
    r_matrix = rng.dirichlet(np.ones(10), size=(13, k)).transpose(0, 2, 1)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jexports.routing_heatmap_tables(alpha, r_matrix, routes, jdir, split="test")
    got = texports.routing_heatmap_tables(alpha, r_matrix, routes, tdir, split="test")
    assert json.dumps(got) == json.dumps(ref)
    names = _compare_dirs(jdir, tdir)
    assert "test_route_audit.json" in names and "test_R_route_given_label_rownorm.npy" in names


@pytest.mark.parametrize("split, n_bins", [("val", 10), ("test", 15)])
def test_reliability_diagram_copy_writes_the_same_files(split, n_bins, tmp_path):
    rng = np.random.default_rng(n_bins)
    y, prob = (rng.random(200) < 0.3).astype(np.float32), rng.random(200) ** 2
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jexports.save_reliability_diagram(y, prob, jdir, split=split, n_bins=n_bins)
    got = texports.save_reliability_diagram(y, prob, tdir, split=split, n_bins=n_bins)
    assert sorted(got) == sorted(ref)
    assert f"{split}_reliability.csv" in _compare_dirs(jdir, tdir)


# --- the train-state checkpoint ---------------------------------------------

STATE = {**TINY, "encoder.vision_norm": "batch", "encoder.text_max_len": 16, "encoder.image_size": 32}


def _state(seed: int, **over):
    """A tiny model's train state with every part moved off its fresh value."""
    cfg = tc.apply_overrides(tc.Config(), {**STATE, **over})
    torch.manual_seed(seed)
    model = build_model(cfg, device="cpu", train=True)
    state = create_train_state(cfg, model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.is_floating_point():
                t.add_(0.01 * torch.randn(t.shape, generator=g).to(t.dtype))
        for part in (state.mu, state.nu, state.ema):
            for t in part.values():
                t.copy_(torch.rand(t.shape, generator=g))
    state.count, state.step = 3, 5
    state.loop = {"lr_scale": 0.5, "best_epoch": 1, "generator": torch.Generator().manual_seed(9).get_state()}
    return cfg, state


def _save(path, cfg, state):
    save_checkpoint(str(path), serving_state_dict(state), cfg, train_state=train_state_dict(state))
    return str(path)


def test_restore_train_state_round_trip(tmp_path):
    cfg, src = _state(1)
    path = _save(tmp_path / "ck", cfg, src)
    assert load_meta(path)["step"] == 5
    _, dst = _state(2)
    restore_train_state(path, dst)
    assert (dst.step, dst.count, dst.loop["lr_scale"], dst.loop["best_epoch"]) == (5, 3, 0.5, 1)
    assert torch.equal(dst.loop["generator"], src.loop["generator"])
    for key, value in src.model.state_dict().items():
        assert torch.equal(dst.model.state_dict()[key], value), key
    for part in ("mu", "nu", "ema"):
        for name, value in getattr(src, part).items():
            assert torch.equal(getattr(dst, part)[name], value), (part, name)
    # the serving weights are the EMA, not the raw parameters
    served = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
    name = src.names[-1]
    assert torch.equal(served[name], src.ema[name]) and not torch.equal(served[name], src.model.state_dict()[name])


def test_restore_train_state_params_only_keeps_fresh_optimizer(tmp_path):
    cfg, src = _state(1)
    path = _save(tmp_path / "ck", cfg, src)
    _, dst = _state(2)
    dst.step, dst.count, dst.loop = 0, 0, {}
    mu = {k: v.clone() for k, v in dst.mu.items()}
    restore_train_state(path, dst, params_only=True)
    assert (dst.step, dst.count, dst.loop) == (0, 0, {})
    for key, value in src.model.state_dict().items():
        assert torch.equal(dst.model.state_dict()[key], value), key
    for name in src.names:
        assert torch.equal(dst.ema[name], src.ema[name]) and torch.equal(dst.mu[name], mu[name])


def test_restore_train_state_casts_to_the_template_dtypes(tmp_path):
    """An fp32-era checkpoint into a run that holds the frozen BERT body in
    bf16, and back."""
    cfg32, src = _state(1)
    path = _save(tmp_path / "ck", cfg32, src)
    cfg16, dst = _state(2, **{"model.dtype": "bfloat16"})
    key = "encoders.bbert.bert.layer_0.intermediate.weight"
    assert dst.model.state_dict()[key].dtype == torch.bfloat16
    restore_train_state(path, dst)
    assert dst.model.state_dict()[key].dtype == torch.bfloat16
    assert torch.equal(dst.model.state_dict()[key], src.model.state_dict()[key].to(torch.bfloat16))
    back = _save(tmp_path / "ck16", cfg16, dst)
    _, again = _state(3)
    restore_train_state(back, again)
    assert again.model.state_dict()[key].dtype == torch.float32
    assert torch.equal(again.model.state_dict()[key], src.model.state_dict()[key].to(torch.bfloat16).float())


@pytest.mark.parametrize("finetune", [False, True])
def test_restore_train_state_converts_the_bert_layout_under_params_only(finetune, tmp_path):
    over = {"encoder.finetune_text": finetune}
    cfg, src = _state(1, **over)
    path = _save(tmp_path / "ck", cfg, src)
    _, dst = _state(2, **over, **{"train.pipeline_parallel": True})
    restore_train_state(path, dst, params_only=True)
    got = dst.model.state_dict()
    ref = src.model.state_dict()
    q = "encoders.bbert.bert.pp_layers.q_kernel"
    assert torch.equal(got[q][0], ref["encoders.bbert.bert.layer_0.attention.attn.q_proj.weight"].t())
    if finetune:  # the EMA of the BERT layers is converted too
        assert torch.equal(dst.ema[q][0], src.ema["encoders.bbert.bert.layer_0.attention.attn.q_proj.weight"].t())
    # and back: a pipeline-layout train state warm-starts a layered run
    back = _save(tmp_path / "pp", cfg, dst)
    _, layered = _state(3, **over)
    restore_train_state(back, layered, params_only=True)
    for key, value in ref.items():
        assert torch.equal(layered.model.state_dict()[key], value), key


def test_restore_train_state_refuses_a_full_restore_across_layouts(tmp_path):
    cfg, src = _state(1)
    path = _save(tmp_path / "ck", cfg, src)
    _, dst = _state(2, **{"train.pipeline_parallel": True})
    with pytest.raises(ValueError, match="different BERT param layouts"):
        restore_train_state(path, dst)


def test_restore_train_state_refuses_a_serving_checkpoint(tmp_path):
    cfg, src = _state(1)
    path = _save(tmp_path / "ck", cfg, src)
    os.remove(os.path.join(path, TRAIN_STATE))
    _, dst = _state(2)
    for params_only in (False, True):
        with pytest.raises(FileNotFoundError, match="serving checkpoint"):
            restore_train_state(path, dst, params_only=params_only)


def test_restore_train_state_refuses_another_trainable_set(tmp_path):
    cfg, src = _state(1)
    path = _save(tmp_path / "ck", cfg, src)
    _, dst = _state(2, **{"encoder.finetune_text": True})
    with pytest.raises(ValueError, match="same trainable set"):
        restore_train_state(path, dst)


# --- the profiler hook ------------------------------------------------------


def test_trace_context_none_is_a_no_op(tmp_path):
    with trace_context(None), annotate("region"):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with trace_context(str(tmp_path / "trace"), cuda=False):
        with annotate("mmr_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        trace = json.load(f)
    assert any(e.get("name") == "mmr_region" for e in trace["traceEvents"])


# --- the interpretability sweep (audit/attribution.py, audit/sweep.py, probes) --

AUDIT_RTOL, AUDIT_ATOL = 2e-4, 2e-5  # tests/test_pallas.py's pair


def jax_permutations(rng, n_mc: int, b: int) -> np.ndarray:
    """The draws of JAX compute_uc_bi_ti(rng=rng, n_mc=n_mc): [n_mc, 3, b]."""

    out = []
    for key in jax.random.split(rng, n_mc):
        out.append([np.asarray(jax.random.permutation(k, b)) for k in jax.random.split(key, 3)])
    return np.asarray(out)


def _head_weights(seed: int, r: int = 7, d: int = 4, k: int = 0):
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(r * d, 16)) / np.sqrt(r * d)).astype(np.float32)
    w2 = rng.normal(size=(16,) + ((k,) if k else ())).astype(np.float32)
    return w1, w2


def test_occlusion_matches_jax_and_finds_the_informative_route():

    rng = np.random.default_rng(0)
    b, r, d = 8, 7, 4
    embs = rng.normal(size=(b, r, d)).astype(np.float32)
    gates = rng.dirichlet(np.ones(r), size=b).astype(np.float32)
    for k in (0, 3):  # logits [B] and [B, K]
        w1, w2 = _head_weights(1, r, d, k)
        ref = np.asarray(jattr.route_contributions_occlusion(lambda x: jnp.tanh(x @ w1) @ w2, jnp.asarray(embs), jnp.asarray(gates)))
        got = tattr.route_contributions_occlusion(lambda x: torch.tanh(x @ torch.from_numpy(w1)) @ torch.from_numpy(w2), torch.from_numpy(embs),
                   torch.from_numpy(gates)).numpy()
        assert got.shape == ref.shape == ((b, r) if k == 0 else (b, r, k))
        np.testing.assert_allclose(got, ref, rtol=AUDIT_RTOL, atol=AUDIT_ATOL)
    w = np.zeros((r * d,), np.float32)  # a head that reads only route 2's block
    w[2 * d: 3 * d] = 1.0
    contrib = tattr.route_contributions_occlusion(lambda x: x @ torch.from_numpy(w), torch.from_numpy(embs), torch.ones(b, r) / r).numpy()
    np.testing.assert_allclose(contrib[:, [0, 1, 3, 4, 5, 6]], 0.0, atol=1e-6)
    assert np.any(np.abs(contrib[:, 2]) > 1e-4)


@pytest.mark.parametrize("kind", ["additive", "pairwise", "nonlinear"])
def test_uc_bi_ti_matches_jax_on_its_permutations(kind):
    """The port's compute_uc_bi_ti fed JAX's permutation draws equals JAX's at
    2e-4 / 2e-5; f(obs) = G + UC + BI + TI on both sides; an additive f has
    no BI or TI, a pairwise product no TI."""


    rng = np.random.default_rng(1)
    b, n_mc = 64, 30
    l, n, i = (rng.normal(size=(b, 2)).astype(np.float32) for _ in range(3))
    fns = {
        "additive": lambda m, a, c, e: (a + 2 * c - e)[:, 0],
        "pairwise": lambda m, a, c, e: (a * c)[:, 0] + e[:, 1],
        "nonlinear": lambda m, a, c, e: m.tanh(a[:, 0] * c[:, 1] + e[:, 0]) * (1 + a[:, 1] * e[:, 1]),
    }
    key = jax.random.PRNGKey(3)
    ref = [np.asarray(x) for x in jattr.compute_uc_bi_ti(lambda a, c, e: fns[kind](jnp, a, c, e), *(jnp.asarray(x) for x in (l, n, i)),
                                          rng=key, n_mc=n_mc)]
    got = [x.numpy() for x in tattr.compute_uc_bi_ti(lambda a, c, e: fns[kind](torch, a, c, e), *(torch.from_numpy(x) for x in (l, n, i)),
                                      permutations=jax_permutations(key, n_mc, b))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=AUDIT_RTOL, atol=AUDIT_ATOL)
    if kind == "additive":
        np.testing.assert_allclose(got[1:], 0.0, atol=1e-5)
    if kind == "pairwise":
        np.testing.assert_allclose(got[2], 0.0, atol=1e-5)
        assert np.abs(got[1]).mean() > 0.1


@pytest.mark.parametrize("n_routes", [7, 10])
def test_block_weights_match_jax(n_routes):


    gates = np.random.default_rng(2).dirichlet(np.ones(n_routes), size=5).astype(np.float32)
    ref = jattr.block_weights_from_gates(jnp.asarray(gates), jget_routes(n_routes))
    got = tattr.block_weights_from_gates(torch.from_numpy(gates), tget_routes(n_routes))
    assert sorted(got) == sorted(ref) == ["bi", "tri", "uni"]
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=AUDIT_RTOL, atol=AUDIT_ATOL)


def _gated_pair(missing_rate: float = 0.25):
    """The JAX tiny gated-concat model (one output, learned gate) on seeded
    variables, the port's holding them, and an 8-stay batch."""
    over = {**TINY, "model.num_classes": 1}
    jcfg, tcfg = jconfigs.apply_overrides(jconfigs.Config(), over), tc.apply_overrides(tc.Config(), over)
    batch = tiny_batch(n=8, seed=4, missing_rate=missing_rate)
    jmodel = jbuild_model(jcfg, "gated_concat")
    variables = jax.tree_util.tree_map(np.asarray, _random_variables(jmodel, batch, seed=5))
    jout = compiled(lambda v, b: jmodel.apply(v, b, train=False), variables, batch)
    tmodel = load_jax_variables(build_model(tcfg, "gated_concat", device="cpu"), variables).eval()
    return jcfg, tcfg, variables, jout, tmodel, batch


def test_gated_sweep_matches_jax_on_bridged_weights(capsys):
    """gated_model_sweep on the JAX model's pooled outputs, availability
    from presence and JAX's permutation draws: every array against JAX's
    gated_model_sweep at 2e-4 / 2e-5; the sweep's logits equal the port
    model's forward; sweep_to_rows and print_inference_demo give JAX's rows
    and text."""
    jcfg, tcfg, variables, jout, tmodel, batch = _gated_pair()
    pooled = {k: np.asarray(v) for k, v in jout.pooled.items()}
    avail = np.array(jroute_mask(batch.has_l, batch.has_n, batch.has_i, ROUTES_7))
    assert 0 < avail.sum() < avail.size
    key = jax.random.PRNGKey(1)
    ref = jsweep.gated_model_sweep(jcfg, variables["params"], pooled, avail=avail, n_mc=4, rng=key)
    got = tsweep.gated_model_sweep(tcfg, tmodel, pooled, avail=torch.from_numpy(avail),
                                   permutations=jax_permutations(key, 4, 8))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=AUDIT_RTOL, atol=AUDIT_ATOL, err_msg=k)
    with torch.no_grad():
        tout = tmodel(torch_batch(batch))
    np.testing.assert_allclose(got["logits"], tout.logits.numpy(), rtol=AUDIT_RTOL, atol=AUDIT_ATOL)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), rtol=AUDIT_RTOL, atol=AUDIT_ATOL)
    avail_t = route_mask_from_presence(*(torch.from_numpy(getattr(batch, f)) for f in ("has_l", "has_n", "has_i")),
                                       ROUTES_7)
    np.testing.assert_array_equal(avail_t.numpy(), avail)
    # the tidy rows and the demo text of one sweep, by both packages' functions
    assert tsweep.sweep_to_rows(ref) == jsweep.sweep_to_rows(ref)
    assert tsweep.print_inference_demo(ref, k=3) == jsweep.print_inference_demo(ref, k=3)
    assert "block means" in capsys.readouterr().out


def test_sweep_needs_the_learned_gate():
    cfg = tc.apply_overrides(tc.Config(), {**TINY, "model.gate_mode": "uniform"})
    model = build_model(cfg, "gated_concat", device="cpu")
    pooled = {k: torch.zeros(2, cfg.encoder.d) for k in ("L", "N", "I")}
    with pytest.raises(ValueError, match="learned gate"):
        tsweep.gated_model_sweep(cfg, model, pooled)


def test_probes_copy_matches_jax():
    rng = np.random.default_rng(9)
    embs = {r: rng.normal(size=(8, 16)) for r in ("L", "N", "I")}
    collapsed = {"A": embs["L"], "B": embs["L"] * 1.001}
    for e in (embs, collapsed):
        assert tprobes.route_cosine_report(e) == jprobes.route_cosine_report(e)
    assert tprobes.route_cosine_report(collapsed)["collapse_suspect"]
    masks = {"chunk": np.array([[1, 0], [0, 0]], np.float32), "m": rng.random((4, 6)) > 0.5}
    assert tprobes.mask_stats(**masks) == jprobes.mask_stats(**masks)
    for x in (np.zeros((4, 4)), rng.normal(size=(300, 500)), rng.integers(0, 3, (50, 7))):
        assert tprobes.quantization_check(x, "x") == jprobes.quantization_check(x, "x")
    batch = tiny_batch(n=2)
    assert tprobes.pretty_print_small_batch(TBatch(*batch)) == jprobes.pretty_print_small_batch(JBatch(*batch))


def test_interpret_matches_the_jax_cli_on_the_same_weights(tmp_path, monkeypatch):
    """`cli interpret` of one JAX-format gated checkpoint (EMA weights) by both
    CLIs: the same CSV columns, and every column that draws no permutation
    (logit, gates, route contributions and norms, block means) within 2e-4 /
    2e-5; UC/BI/TI take each package's own draws."""
    jcfg = jconfigs.apply_overrides(jconfigs.Config(), TINY_SETS)
    model = jbuild_model(jcfg, "gated_concat")
    example = tiny_batch(n=8, seed=0)
    variables = _random_variables(model, example, seed=6)
    state = jcreate_train_state(jcfg, model, jax.tree_util.tree_map(jax.numpy.asarray, variables))
    ema = jitter({"params": variables["params"]}, seed=7, scale=0.05)["params"]
    state = state.replace(ema_params=jax.tree_util.tree_map(jax.numpy.asarray, ema))
    jdir = str(tmp_path / "jax")
    jsave_checkpoint(jdir, state, jcfg, name="final")
    _template_init(monkeypatch)
    tables, texts = {}, {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        path = str(tmp_path / f"{name}.csv")
        argv = ["interpret", "--ckpt", jdir, "--out-csv", path, "--n-mc", "2", "--max-samples", "8"]
        rc, texts[name] = run_cli(main, argv + (["--device", "cpu"] if name == "port" else []))
        assert rc == 0
        with open(path) as f:
            tables[name] = list(csv.DictReader(f))
    assert list(tables["port"][0]) == list(tables["jax"][0]) and len(tables["port"]) == len(tables["jax"]) == 8
    for col in tables["jax"][0]:
        if col in ("uc", "bi", "ti"):
            continue
        np.testing.assert_allclose([float(r[col]) for r in tables["port"]], [float(r[col]) for r in tables["jax"]],
                                   rtol=AUDIT_RTOL, atol=AUDIT_ATOL, err_msg=col)
    assert texts["port"].count("sample ") == texts["jax"].count("sample ") == 5
