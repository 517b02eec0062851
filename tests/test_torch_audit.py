"""The port's copies of the JAX package's numpy audit modules (fairness, the
drop table, the route heatmap tables and reliability diagram) against the
originals, the train-state checkpoint (``ckpt.restore_train_state``) and
the profiler hook."""
import json
import os

import numpy as np
import pytest
import torch

from multimodalrouting_tpu.audit import droptable as jdrop
from multimodalrouting_tpu.audit import exports as jexports
from multimodalrouting_tpu.data.batches import Batch as JBatch
from multimodalrouting_tpu.metrics import fairness as jfair
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.audit import droptable as tdrop
from multimodalrouting_tpu_torch.audit import exports as texports
from multimodalrouting_tpu_torch.ckpt import TRAIN_STATE, load_meta, restore_train_state, save_checkpoint
from multimodalrouting_tpu_torch.data.batches import Batch as TBatch
from multimodalrouting_tpu_torch.metrics import fairness as tfair
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train.state import create_train_state, serving_state_dict, train_state_dict
from multimodalrouting_tpu_torch.utils.profiling import annotate, trace_context
from tests.helpers import TINY, tiny_batch

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
