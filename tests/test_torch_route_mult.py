"""The port's per-route MulT family (models/route_mult.py) against the JAX
package's on the CPU, fp32, dropouts at 0:

- ``_native_causal_bias`` and ``_last_valid`` (an empty mask pools row 0);
- ``PerRouteMulTFusion`` (every route) at equal and unequal sequence
  lengths, causal on and off, masks with data pads and empty rows, and its
  gradients against ``jax.grad`` (parameters and inputs); a data pad of the
  attended sequence moves the routes, as the reference attends it;
- ``MulTCrossAttentionFusion`` (one route, a stack of one stream), with
  and without the causal mask and the sinusoidal positions;
- the whole configs/pheno_atten_mult.yaml model at tiny widths (logits,
  alpha, R-matrix, every route embedding) and one frozen train step
  against JAX ``make_train_step``, per leaf within 5e-4 in relative norm.

JAX weights come from ``jax.eval_shape`` of the init filled with seeded
values (``seeded_like``); the JAX programs are compiled with ``O0``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models import route_mult as jrm
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.models import route_mult as trm
from multimodalrouting_tpu_torch.models.full import build_model
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_close,
    assert_step,
    compiled,
    jax_forwards,
    one_torch_thread,
    seeded_like,
    seeded_variables,
    t,
    to_numpy,
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D, HEADS, B = 16, 4, 3
LENGTHS = {"equal": (5, 5, 5), "unequal": (5, 3, 7)}
YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pheno_atten_mult.yaml")
# configs/pheno_atten_mult.yaml's model section, at the tiny widths of
# tests/helpers.py with every dropout at 0
ATTEN_MULT = {
    **TINY, "model.task": "pheno", "model.num_classes": 25, "model.routes": "10", "model.bi_fusion_mode": "mult",
    "model.cross_attn_layers": 1, "model.cross_attn_mask": True, "model.capsule_act_type": "sigmoid_gate",
    "model.attn_dropout": 0.0, "model.relu_dropout": 0.0, "model.res_dropout": 0.0, "model.embed_dropout": 0.0,
    "encoder.text_max_len": 16, "encoder.image_size": 32,
}


def _inputs(lengths, seed: int = 5):
    """Sequences [B, T, D] and prefix masks with data pads; row 0 of L and
    row 1 of I have empty masks."""
    rng = np.random.default_rng(seed)
    seqs, masks = [], []
    for t_len in lengths:
        seqs.append(rng.standard_normal((B, t_len, D)).astype(np.float32))
        n_valid = rng.integers(1, t_len + 1, size=(B,))
        masks.append((np.arange(t_len)[None, :] < n_valid[:, None]).astype(np.float32))
    masks[0][0] = 0.0
    masks[2][1] = 0.0
    return seqs, masks


def _pools(seqs, seed: int = 6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, D)).astype(np.float32) for _ in seqs]


def _route_args(seqs, masks, pools):
    return [x for trio in zip(seqs, masks, pools) for x in trio]


@functools.lru_cache(maxsize=None)
def _fusion_case(layers: int, causal: bool, lengths: tuple):
    """(JAX module, numpy variables) of PerRouteMulTFusion."""
    module = jrm.PerRouteMulTFusion(d=D, n_heads=HEADS, layers=layers, attn_mask=causal)
    seqs, masks = _inputs(lengths)
    args = [jnp.asarray(x) for x in _route_args(seqs, masks, _pools(seqs))]
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return module, seeded_like(shapes, 11)


def _port_fusion(variables, layers: int, causal: bool):
    return load_jax_variables(trm.PerRouteMulTFusion(D, HEADS, layers, attn_mask=causal), variables)


def test_native_causal_bias_and_last_valid_match_jax():
    for causal in (True, False):
        for lengths in LENGTHS.values():
            streams = jrm.DIRECTIONAL_STREAMS
            ref = np.asarray(jrm._native_causal_bias(streams, list(lengths), max(lengths), causal))
            np.testing.assert_array_equal(trm._native_causal_bias(streams, list(lengths), max(lengths), causal).numpy(),
                                          ref)
    assert trm.DIRECTIONAL_STREAMS == jrm.DIRECTIONAL_STREAMS and trm.TRI_STREAMS == jrm.TRI_STREAMS
    x = np.random.default_rng(0).standard_normal((3, 4, 2)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    for m in (mask, None):
        ref = np.asarray(jrm._last_valid(jnp.asarray(x), None if m is None else jnp.asarray(m)))
        np.testing.assert_array_equal(trm._last_valid(t(x), None if m is None else t(m)).numpy(), ref)
    np.testing.assert_array_equal(trm._last_valid(t(x), t(mask))[1].numpy(), x[1, 0])  # empty: row 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "no-mask"])
@pytest.mark.parametrize("lengths", list(LENGTHS), ids=list(LENGTHS))
def test_per_route_fusion_matches_jax(lengths, causal):
    """Every route at 2e-4 / 2e-5, two layers per stack."""
    module, variables = _fusion_case(2, causal, LENGTHS[lengths])
    seqs, masks = _inputs(LENGTHS[lengths])
    args = _route_args(seqs, masks, _pools(seqs))
    ref = compiled(lambda v, *a: module.apply(v, *a), variables, *[jnp.asarray(x) for x in args])
    tmod = _port_fusion(variables, 2, causal)
    with torch.no_grad():
        got = tmod(*[t(x) for x in args])
    assert sorted(got) == sorted(ref) and len(got) == 10
    for name in ref:
        assert_close(got[name], ref[name], err_msg=name)
    # the data pads of the attended sequence are attended (the reference
    # attends B's padded positions): LN moves with N's masked steps
    moved = [x.copy() for x in args]
    pads = masks[1] == 0.0
    moved[3][pads] += np.random.default_rng(9).standard_normal((int(pads.sum()), D)).astype(np.float32)
    with torch.no_grad():
        again = tmod(*[t(x) for x in moved])
    assert not torch.allclose(again["LN"], got["LN"])


@pytest.mark.parametrize("causal, positional", [(True, True), (False, True), (True, False)],
                         ids=["causal", "no-mask", "no-positions"])
def test_cross_attention_fusion_matches_jax(causal, positional):
    """One directional route alone; the port's stack of one stream holds the
    JAX stack's parameters with a leading stream axis."""
    seqs, masks = _inputs(LENGTHS["unequal"])
    module = jrm.MulTCrossAttentionFusion(d=D, n_heads=HEADS, layers=1, attn_mask=causal, use_positional=positional)
    args = [jnp.asarray(x) for x in (seqs[0], masks[0], seqs[2], masks[2])]
    variables = seeded_like(jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args), 12)
    ref = compiled(lambda v, *a: module.apply(v, *a), variables, *args)
    stacked = jax.tree_util.tree_map(lambda x: x[None], variables)
    tmod = load_jax_variables(trm.MulTCrossAttentionFusion(D, HEADS, 1, attn_mask=causal, use_positional=positional),
                              stacked)
    with torch.no_grad():
        got = tmod(*[t(x) for x in (seqs[0], masks[0], seqs[2], masks[2])])
    assert_close(got, ref)


def test_per_route_fusion_gradients_match_jax():
    """d(sum_r <route_r, w_r>) with respect to every parameter and the three
    sequences, against jax.grad, unequal lengths, causal."""
    module, variables = _fusion_case(2, True, LENGTHS["unequal"])
    seqs, masks = _inputs(LENGTHS["unequal"])
    pools = _pools(seqs)
    rng = np.random.default_rng(8)
    weights = {r: rng.standard_normal((B, D)).astype(np.float32) for r in ("L", "N", "I", *jrm.DIRECTIONAL_NAMES, "LNI")}

    def jloss(v, l_seq, n_seq, i_seq):
        routes = module.apply(v, l_seq, masks[0], pools[0], n_seq, masks[1], pools[1], i_seq, masks[2], pools[2])
        return sum(jnp.sum(routes[r] * weights[r]) for r in weights)

    jgrads = compiled(jax.grad(jloss, argnums=(0, 1, 2, 3)), variables, *[jnp.asarray(s) for s in seqs])
    tmod = _port_fusion(variables, 2, True)
    xs = [t(s).requires_grad_(True) for s in seqs]
    routes = tmod(xs[0], t(masks[0]), t(pools[0]), xs[1], t(masks[1]), t(pools[1]), xs[2], t(masks[2]), t(pools[2]))
    sum((routes[r] * t(w)).sum() for r, w in weights.items()).backward()
    ref = state_dict_from_jax({"params": to_numpy(jgrads[0])["params"]}, tmod)
    named = dict(tmod.named_parameters())
    assert sorted(ref) == sorted(named)
    for name, g in ref.items():
        assert_close(named[name].grad, g, err_msg=name)
    for x, g in zip(xs, jgrads[1:]):
        assert_close(x.grad, g)


def _model_case():
    jcfg = jc.apply_overrides(jc.Config(), ATTEN_MULT)
    tcfg = tc.apply_overrides(tc.Config(), ATTEN_MULT)
    batch = tiny_batch(n=6, seed=2, task="pheno", missing_rate=0.3)
    model = jbuild_model(jcfg, "capsule")
    return jcfg, tcfg, model, seeded_variables(model, jax.tree_util.tree_map(jnp.asarray, batch), 3), batch


def test_the_yaml_selects_the_family():
    cfg = tc.load_cfg(YAML, environ={})
    m = cfg.model
    assert (m.task, m.num_classes, m.routes, m.bi_fusion_mode, m.cross_attn_layers, m.cross_attn_mask,
            m.capsule_act_type) == ("pheno", 25, "10", "mult", 1, True, "sigmoid_gate")
    assert cfg.train.pos_weight_clip == (0.1, 5.0)
    model = build_model(tc.apply_overrides(cfg, {k: v for k, v in ATTEN_MULT.items() if not k.startswith("model.")}),
                        device="cpu")
    assert hasattr(model, "route_mult") and not hasattr(model, "mult")
    assert model.capsule_head.routing_mode == "sigmoid_routes"


def test_pheno_atten_mult_forward_matches_jax():
    jcfg, tcfg, model, variables, batch = _model_case()
    ref, = jax_forwards(model, variables, batch, [{}])
    tmodel = load_jax_variables(build_model(tcfg, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(torch_batch(batch))
    assert tuple(got.r_matrix.shape) == (6, 10, 25)
    for name in ("logits", "alpha", "r_matrix", "chexpert_logits"):
        assert_close(getattr(got, name), getattr(ref, name), err_msg=name)
    for name, emb in ref.route_embs.items():
        assert_close(got.route_embs[name], emb, err_msg=name)


def test_pheno_atten_mult_frozen_step_matches_jax():
    """One capsule-family step (the pos-weighted multi-label loss, the
    sigmoid gate), BERT frozen, from the same weights."""
    jcfg, tcfg, model, variables, batch = _model_case()
    _, tmodel, state, _ = assert_step(tcfg, "capsule", "capsule", (jcfg, model, variables), batch)
    assert not any(n.startswith("encoders.bbert.bert.") for n in state.names)
    assert any(n.startswith("route_mult.directional.") for n in state.names)
