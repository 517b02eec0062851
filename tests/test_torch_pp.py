"""The port's pipeline-parallel BERT layout on one device (parallel/pp.py)
against the JAX package on the CPU: the layout converters, the stacked layer
stack and the chunk BERT on it, the flagship model with
train.pipeline_parallel=true, one layer through the upstream flash kernel in
TPU interpret mode, serving across the two layouts, and train_model's
checks."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodalrouting_tpu import configs as jconfigs
from multimodalrouting_tpu.models.clinbert import BertEncoder as JBertEncoder
from multimodalrouting_tpu.models.clinbert import BioClinBERTEncoder as JBioClinBERT
from multimodalrouting_tpu.ops import flash as jflash
from multimodalrouting_tpu.parallel import pp as jpp
from multimodalrouting_tpu_torch import configs as tconfigs
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.ckpt import convert_bert_layout, load_weights, save_checkpoint
from multimodalrouting_tpu_torch.models.clinbert import BertEncoder, BioClinBERTEncoder
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.parallel import pp as tpp
from multimodalrouting_tpu_torch.serve import Predictor
from multimodalrouting_tpu_torch.train.loop import train_model
from tests.helpers import TINY, tiny_batch
from tests.test_torch_model import OUTPUTS, SLICE, _jax_eval, _jax_model
from tests.torch_parity import assert_close, jitter, t, torch_batch

KEY = jax.random.PRNGKey(0)
BERT = dict(vocab_size=200, hidden=64, layers=3, heads=4, intermediate=96, max_position=32)


def _notes(b, s, length, seed):
    rng = np.random.default_rng(seed)
    notes = {
        "input_ids": rng.integers(1, 200, size=(b, s, length)).astype(np.int32),
        "attention_mask": (rng.random((b, s, length)) > 0.2).astype(np.int32),
        "chunk_mask": np.array([[1, 1, 0], [1, 0, 0]], np.float32)[:b, :s],
    }
    notes["attention_mask"][:, :, 0] = 1
    notes["attention_mask"] *= notes["chunk_mask"][..., None].astype(np.int32)
    return notes


def _layered_bert(seed=0):
    """A layered JAX BertEncoder's jittered variables and the port's
    BertEncoder holding the same weights."""
    ids = np.ones((2, 16), np.int32)
    variables = jitter(JBertEncoder(**BERT).init(KEY, ids, ids), seed=seed)
    return variables, load_jax_variables(BertEncoder(**BERT), variables)


def test_layout_converters_round_trip_and_match_jax():
    """The port's to_pp_layout on state_dict keys == the JAX package's on
    its param tree, leaf for leaf; from_pp_layout inverts it exactly."""
    variables, tmodel = _layered_bert(seed=1)
    sd = tmodel.state_dict()
    stacked = tpp.to_pp_layout(sd)
    assert not any(k.startswith("layer_") for k in stacked)
    ref = jpp.to_pp_layout(variables["params"])
    for name in tpp.LEAVES:
        assert_close(stacked[f"pp_layers.{name}"], ref["pp_layers"][name], rtol=0, atol=0, err_msg=name)
    back = tpp.from_pp_layout(stacked)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # a prefix selects one encoder inside a bigger state_dict
    outer = {f"enc.bert.{k}": v for k, v in sd.items()}
    outer["head.w"] = torch.ones(3)
    conv = tpp.to_pp_layout(outer, "enc.bert.")
    assert "head.w" in conv and "enc.bert.pp_layers.q_kernel" in conv
    assert sorted(tpp.from_pp_layout(conv, "enc.bert.")) == sorted(outer)


@pytest.mark.parametrize("length", [16, 256])
def test_bioclinbert_pipeline_matches_jax(length):
    """BioClinBERTEncoder(pipeline=True) against the JAX one with bridged
    stacked weights; at L=256 every layer takes K4a's plain version on the
    CPU (the JAX package the eager attention: equal on valid tokens)."""
    notes = _notes(2, 3, length, seed=length)
    kw = dict(d=32, note_agg="mean", chunk_agg="mean", gelu="poly", ln="bf16", vocab_size=200, hidden=128,
              layers=2, heads=2, intermediate=96, max_position=length, pipeline=True)
    jm = JBioClinBERT(**kw)
    variables = jitter(jm.init(KEY, notes), seed=3)
    assert "pp_layers" in variables["params"]["bert"]
    ref = jm.apply(variables, notes)
    tm = load_jax_variables(BioClinBERTEncoder(**kw), variables).eval()
    assert "bert.pp_layers.q_kernel" in tm.state_dict()
    with torch.no_grad():
        got = tm({k: t(v) for k, v in notes.items()})
    for g, r, name in zip(got, ref, ("seq", "mask", "pooled")):
        assert_close(g, r, err_msg=name)


def test_pipelined_layers_match_jax_stack():
    """PipelinedBertLayers alone (the sequential loop) against the JAX
    module's scan, with every token valid and a ragged chunk."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 16, 64)).astype(np.float32)
    mask = np.ones((3, 16), np.float32)
    mask[1, 10:] = 0.0
    jm = jpp.PipelinedBertLayers(layers=2, hidden=64, heads=4, intermediate=96, gelu="erf")
    variables = jitter(jm.init(KEY, x, mask), seed=4)
    ref = jm.apply(variables, x, mask)
    tm = tpp.PipelinedBertLayers(2, 64, 4, 96, gelu="erf")
    tm.load_state_dict(state_dict_from_jax(variables, tm))
    with torch.no_grad():
        got = tm(t(x), t(mask))
    assert_close(got, ref)


def test_bert_layer_through_the_flash_kernel_matches_jax():
    """One bert_layer_fwd at T=256 where the JAX package runs the upstream
    flash kernel in context (flash_available forced on, TPU interpret mode)
    and the port runs K4a's plain version: every row, pad tokens included."""
    rng = np.random.default_rng(8)
    n, length, hidden, heads, inter = 2, 256, 128, 2, 96
    shapes = dict(q_kernel=(hidden, hidden), k_kernel=(hidden, hidden), v_kernel=(hidden, hidden),
                  o_kernel=(hidden, hidden), i_kernel=(hidden, inter), f_kernel=(inter, hidden))
    w = {name: (rng.normal(size=shapes[name]) * shapes[name][0] ** -0.5).astype(np.float32) for name in shapes}
    for name in ("q_bias", "k_bias", "v_bias", "o_bias", "f_bias", "attn_ln_bias", "ln_bias"):
        w[name] = (0.1 * rng.normal(size=(hidden,))).astype(np.float32)
    w["i_bias"] = (0.1 * rng.normal(size=(inter,))).astype(np.float32)
    w["attn_ln_scale"] = (1 + 0.1 * rng.normal(size=(hidden,))).astype(np.float32)
    w["ln_scale"] = (1 + 0.1 * rng.normal(size=(hidden,))).astype(np.float32)
    x = rng.normal(size=(n, length, hidden)).astype(np.float32)
    mask = np.ones((n, length), np.float32)
    mask[0, 100:] = 0.0
    mask[1] = 0.0  # an all-pad chunk
    calls = []
    real = jflash.flash_self_attention

    def spy(*a):
        calls.append(1)
        return real(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(jflash, "flash_available", lambda: True)
    mp.setattr(jflash, "flash_self_attention", spy)
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jpp.bert_layer_fwd({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jnp.asarray(mask),
                                     heads=heads, dtype=jnp.float32, gelu="poly")
    finally:
        mp.undo()
    assert calls, "the JAX layer did not take the flash kernel"
    got = tpp.bert_layer_fwd({k: t(v) for k, v in w.items()}, t(x), t(mask), heads=heads, dtype=torch.float32,
                             gelu="poly")
    assert torch.isfinite(got).all()
    assert_close(got, ref)


def _cfgs(**extra):
    over = {**SLICE, "train.pipeline_parallel": True, **extra}
    return jconfigs.apply_overrides(jconfigs.Config(), over), tconfigs.apply_overrides(tconfigs.Config(), over)


@pytest.mark.parametrize("missing_rate", [0.0, 0.3])
def test_capsule_routing_model_pipeline_layout_matches_jax(missing_rate):
    """The flagship at the tiny config with train.pipeline_parallel=true on
    one device: the JAX model's scan path and the port's loop, bridged
    stacked weights."""
    jcfg, tcfg = _cfgs()
    batch = tiny_batch(n=5, seed=3, missing_rate=missing_rate)
    model, variables = _jax_model(jcfg, batch, seed=21)
    assert "pp_layers" in variables["params"]["encoders"]["bbert"]["bert"]
    ref = _jax_eval(model, variables, batch, jcfg)
    tmodel = load_jax_variables(build_model(tcfg, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    for name in OUTPUTS:
        assert_close(getattr(got, name), getattr(ref, name), err_msg=name)


def _write(ckpt, model, cfg):
    save_checkpoint(ckpt, model.state_dict(), cfg, temperature=1.2, thresholds=[0.5])
    return ckpt


def _relabel(src, dst, pipeline: bool):
    """The checkpoint `src` with its weights file as it is and the config's
    train.pipeline_parallel set to `pipeline`."""
    os.makedirs(dst)
    for name in ("weights.pt", "meta.json"):
        os.link(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg["train"]["pipeline_parallel"] = pipeline
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_serve_across_layouts(tmp_path, dtype):
    """A layered checkpoint served from a pipeline-layout config equals the
    layered model, and the reverse (the JAX package's restore converts the
    same way); under bf16 the frozen body is held in bf16 in both layouts."""
    over = {**TINY, "encoder.text_max_len": 16, "model.dtype": dtype}
    cfg = tconfigs.apply_overrides(tconfigs.Config(), over)
    torch.manual_seed(0)
    layered = _write(str(tmp_path / "layered"), build_model(cfg, device="cpu"), cfg)
    pp_cfg = tconfigs.apply_overrides(tconfigs.Config(), {**over, "train.pipeline_parallel": True})
    torch.manual_seed(1)
    stacked = _write(str(tmp_path / "stacked"), build_model(pp_cfg, device="cpu"), pp_cfg)
    batch = tiny_batch(n=3, seed=4)
    for src, relabelled in ((layered, _relabel(layered, str(tmp_path / "as_pp"), True)),
                            (stacked, _relabel(stacked, str(tmp_path / "as_layered"), False))):
        want, got = Predictor(src, device="cpu"), Predictor(relabelled, device="cpu")
        assert any(".pp_layers." in k for k in got.model.state_dict()) != any(
            ".pp_layers." in k for k in want.model.state_dict())
        body = got.model.encoders.bbert.bert.embed_ln.weight.dtype
        assert body == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        a, b = want.predict(batch), got.predict(batch)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        for key in ("probs", "alpha", "r_matrix"):
            np.testing.assert_allclose(b[key], a[key], rtol=tol, atol=tol, err_msg=key)
    # the conversion itself: weights of one layout land in the other exactly
    sd = load_weights(layered)
    conv = load_weights(layered, like=build_model(pp_cfg, device="cpu").state_dict())
    back = convert_bert_layout(conv, sd)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize(
    "over",
    [{"train.num_data_shards": 2}, {"train.num_model_shards": 2, "train.tensor_parallel": True},
     {"train.num_model_shards": 2, "encoder.bert_layers": 3}, {"train.num_model_shards": 2, "encoder.bert_layers": 2, "encoder.dropout": 0.1}],
)
def test_train_model_raises_as_validate_pp(over):
    """Pipeline-parallel training on a mesh: the JAX package's checks and
    messages first."""
    over = {**TINY, "train.pipeline_parallel": True, **over}
    jcfg = jconfigs.apply_overrides(jconfigs.Config(), over)
    tcfg = tconfigs.apply_overrides(tconfigs.Config(), over)
    with pytest.raises(ValueError) as want:
        jpp.validate_pp(jcfg, jcfg.train.num_model_shards)
    with pytest.raises(ValueError) as got:
        train_model(tcfg, None, None, None)
    assert str(got.value) == str(want.value)


def test_train_model_on_a_pipeline_mesh_asks_for_its_process_group():
    """A valid pipeline config, which the port refused before the GPipe
    schedule was ported, passes the checks and, in one process, asks for
    its two ranks' launch before it sets a mesh (tests/test_torch_pp_mesh.py
    trains it on them)."""
    from multimodalrouting_tpu_torch.parallel.mesh import get_active_mesh

    over = {**TINY, "train.pipeline_parallel": True, "train.num_model_shards": 2, "encoder.bert_layers": 2}
    cfg = tconfigs.apply_overrides(tconfigs.Config(), over)
    tpp.validate_pp(cfg, 2)  # a valid pipeline config: the process group is what is missing
    with pytest.raises(RuntimeError, match="needs a process group: launch 2 processes"):
        train_model(cfg, None, None, None)
    assert get_active_mesh() is None
