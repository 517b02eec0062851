"""The port's routing modules against the JAX package's on the CPU: every
fusion (``models/fusions.py``), the gates and heads (``routing/gates.py``),
sMRO's ``MMRouting`` and loss-based fusion (``routing/smro.py``, outputs
and gradients against ``jax.grad``), the fairness losses and
``block_mask_for_stage``. The same numpy inputs and flax weights (seeded
values at the init's shapes, so that zero-initialised leaves carry signal,
loaded through ``bridge.py``) go through both, in fp32, at 2e-4 / 2e-5;
the JAX side runs as one compiled program per check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import routes as jroutes
from multimodalrouting_tpu.models import fusions as jf
from multimodalrouting_tpu.routing import gates as jg
from multimodalrouting_tpu.routing import smro as js
from multimodalrouting_tpu.train import losses as jl
from multimodalrouting_tpu_torch import routes as troutes
from multimodalrouting_tpu_torch.bridge import load_jax_variables, state_dict_from_jax
from multimodalrouting_tpu_torch.models import fusions as tf
from multimodalrouting_tpu_torch.routing import gates as tg
from multimodalrouting_tpu_torch.routing import smro as ts
from multimodalrouting_tpu_torch.train import losses as tl
from tests.torch_parity import assert_close, compiled, one_torch_thread, seeded_like, t  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D, B = 8, 5
ROUTES7 = jroutes.get_routes("7")


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _masks(b, n, seed=0, empty=()):
    m = (np.random.default_rng(seed).random((b, n)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    for i in empty:
        m[i] = 0.0
    return m


def _variables(jmod, jin, seed):
    """Seeded weights at `jmod`'s init shapes (no init run)."""
    return seeded_like(jax.eval_shape(lambda *x: jmod.init(jax.random.PRNGKey(0), *x), *jin), seed)


def _same(jmod, tmod, inputs, seed=0):
    """Seeded weights for `jmod` on `inputs`, loaded into `tmod` too;
    -> (JAX output, port output)."""
    jin = [jnp.asarray(x) for x in inputs]
    variables = _variables(jmod, jin, seed)
    ref = compiled(jmod.apply, variables, *jin)
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(*(t(x) for x in inputs))
    return ref, got


def _close_tree(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_close(got[k], ref[k], err_msg=k)
    elif isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _close_tree(g, r)
    else:
        assert_close(got, ref)


@pytest.mark.parametrize("hidden", [None, [12]])
def test_mlp_block(hidden):
    ref, got = _same(jf.MLPBlock(out_dim=3, hidden=hidden), tf.MLPBlock(D, 3, hidden=hidden, p_drop=0.0),
                     [_x(B, D)])
    _close_tree(got, ref)


@pytest.mark.parametrize("pool", ["mean", "first"])
def test_directional_cross_attn_fusion(pool):
    """Sample 1 has no valid B token (-> out(0)); sample 2's A mask starts
    late (pool=first takes its first valid token); sample 3 has no A."""
    a_seq, b_seq = _x(B, 4, D, seed=9), _x(B, 3, D, seed=10)
    a_mask, b_mask = _masks(B, 4, seed=1), _masks(B, 3, seed=2, empty=(1,))
    a_mask[2, :2] = 0.0
    a_mask[3] = 0.0
    tmod = tf.DirectionalCrossAttnFusion(D, 2, 0.0, pool=pool)
    ref, got = _same(jf.DirectionalCrossAttnFusion(d=D, n_heads=2, pool=pool), tmod, [a_seq, a_mask, b_seq, b_mask],
                     seed=6)
    _close_tree(got, ref)
    with torch.no_grad():
        assert_close(got[1], tmod.out_proj_fc(tmod.out_proj_ln(torch.zeros(1, D)))[0])


def test_tri_token_attention_fusion():
    """Sample 0 has no valid token in any modality: out(0)."""
    seqs = [_x(B, n, D, seed=11 + n) for n in (3, 2, 4)]
    masks = [_masks(B, n, seed=n) for n in (3, 2, 4)]
    for m in masks:
        m[0] = 0.0
    inputs = [seqs[0], masks[0], seqs[1], masks[1], seqs[2], masks[2]]
    ref, got = _same(jf.TriTokenAttentionFusion(d=D, n_heads=2), tf.TriTokenAttentionFusion(D, 2, 0.0), inputs,
                     seed=7)
    _close_tree(got, ref)


@pytest.mark.parametrize("bi, tri, feature_mode", [
    ("mlp", "mlp", "rich"), ("mlp", "mlp", "concat"), ("attn", "attn", "rich"), ("linear", "linear", "rich"),
])
def test_seven_route_fusion(bi, tri, feature_mode):
    """Every pair and trimodal fusion, by mode: PairwiseFusion and
    TrimodalFusion on rich and concatenated features (mlp), CrossModalEncoder
    and TrimodalCrossEncoder (attn), the bias-free Dense ones (linear)."""
    zs = [_x(B, D, seed=20 + i) for i in range(3)]
    jmod = jf.SevenRouteFusion(d=D, feature_mode=feature_mode, bi_fusion_mode=bi, tri_fusion_mode=tri)
    tmod = tf.SevenRouteFusion(D, D, feature_mode=feature_mode, bi_fusion_mode=bi, tri_fusion_mode=tri, p_drop=0.0)
    ref, got = _same(jmod, tmod, zs, seed=8)
    assert list(got) == ["L", "N", "I", "LN", "LI", "NI", "LNI"]
    _close_tree(got, ref)


def test_stacked_route_heads_and_route_head():
    """The stacked heads normalise by hand (eps 1e-6, population variance);
    each route equals its own RouteHead (eps 1e-5 LayerNorm) only up to the
    epsilon, so each is held against its own JAX module."""
    z = _x(B, 7, D, seed=30)
    ref, got = _same(jg.StackedRouteHeads(num_routes=7, n_tasks=3), tg.StackedRouteHeads(7, D, 3, p_drop=0.0), [z],
                     seed=9)
    _close_tree(got, ref)
    ref, got = _same(jg.RouteHead(n_tasks=3), tg.RouteHead(D, 3, p_drop=0.0), [z[:, 0]], seed=10)
    _close_tree(got, ref)


@pytest.mark.parametrize("with_avail", [False, True])
def test_route_gate_net(with_avail):
    zs = [_x(B, D, seed=40 + i) for i in range(3)]
    avail = _masks(B, 7, seed=3)
    jmod, tmod = jg.RouteGateNet(num_routes=7, hidden=16), tg.RouteGateNet(3 * D, 7, hidden=16, p_drop=0.0)
    jin = [jnp.asarray(x) for x in zs]
    variables = _variables(jmod, jin, 11)
    ref = compiled(lambda v, *x: jmod.apply(v, *x, avail=jnp.asarray(avail) if with_avail else None), variables, *jin)
    load_jax_variables(tmod, variables)
    got = tmod(*(t(x) for x in zs), avail=t(avail) if with_avail else None)
    assert_close(got, ref)
    np.testing.assert_allclose(got.detach().sum(1).numpy(), 1.0, atol=1e-5)


def test_gate_functions():
    avail = _masks(B, 7, seed=4)
    avail[2] = 0.0  # nothing available
    losses = np.abs(_x(B, 7, seed=50))
    assert_close(tg.uniform_gates(t(avail)), jg.uniform_gates(jnp.asarray(avail)))
    for alpha in (1.0, 5.0):
        assert_close(tg.loss_based_gates(t(losses), t(avail), alpha),
                     jg.loss_based_gates(jnp.asarray(losses), jnp.asarray(avail), alpha))


@pytest.mark.parametrize("l2norm", [False, True])
def test_concat_routes(l2norm):
    embs = {r: _x(B, D, seed=60 + i) for i, r in enumerate(ROUTES7)}
    embs["NI"][1] = 0.0  # a zero route embedding under l2norm
    gates = np.abs(_x(B, 7, seed=61))
    ref = jg.concat_routes({k: jnp.asarray(v) for k, v in embs.items()}, jnp.asarray(gates), ROUTES7, l2norm=l2norm)
    got = tg.concat_routes({k: t(v) for k, v in embs.items()}, t(gates), ROUTES7, l2norm=l2norm)
    _close_tree(got, ref)


def test_final_concat_head():
    ref, got = _same(jg.FinalConcatHead(num_routes=7, d=4, n_tasks=2, hidden=[16, 8]),
                     tg.FinalConcatHead(7, 4, 2, hidden=[16, 8], p_drop=0.0), [_x(B, 28, seed=70)], seed=12)
    _close_tree(got, ref)
    # the default hidden widths [4 R d, 2 R d]
    ref, got = _same(jg.FinalConcatHead(num_routes=7, d=2, n_tasks=1), tg.FinalConcatHead(7, 2, 1, p_drop=0.0),
                     [_x(B, 14, seed=71)], seed=13)
    _close_tree(got, ref)


# --- sMRO ---------------------------------------------------------------------

@pytest.mark.parametrize("strict", [False, True], ids=["gate-trains", "strict-freeze-gate"])
@pytest.mark.parametrize("stage", [None, "uni", "bi", "tri"])
def test_mm_routing_outputs_and_gradients(stage, strict):
    """Outputs, and gradients of a weighted sum of them (fused, route_w,
    block_w) with respect to every parameter, the route logits and the
    context, against jax.grad: the stop-gradients sit where JAX puts them
    (at bi the gate weight w_uni trains unless strict_freeze_gate)."""
    logits, zs = _x(B, 7, 3, seed=80), [_x(B, D, seed=81 + i) for i in range(3)]
    cot = [_x(B, 3, seed=90), _x(B, 7, seed=91), _x(B, 3, seed=92)]
    jmod = js.MMRouting(routes=ROUTES7, gate_hidden=16, strict_freeze_gate=strict)
    jin = [jnp.asarray(x) for x in [logits, *zs]]
    variables = _variables(jmod, jin, 14)

    def jloss(params, lg, zl):
        out = jmod.apply({"params": params}, lg, zl, jin[2], jin[3], stage=stage)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip((out.fused, out.route_w, out.block_w), cot)), out

    (_, ref), jgrads = compiled(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True), variables["params"],
                                jin[0], jin[1])

    tmod = load_jax_variables(ts.MMRouting(ROUTES7, 3 * D, gate_hidden=16, p_drop=0.0, strict_freeze_gate=strict),
                              variables)
    lg, zl = t(logits).requires_grad_(), t(zs[0]).requires_grad_()
    out = tmod(lg, zl, t(zs[1]), t(zs[2]), stage=stage)
    for name in ("fused", "route_w", "block_w", "block_logits"):
        assert_close(getattr(out, name), getattr(ref, name), err_msg=name)
    loss = sum((o * t(c)).sum() for o, c in zip((out.fused, out.route_w, out.block_w), cot))
    loss.backward()
    assert_close(lg.grad, jgrads[1], err_msg="d route_logits")
    assert_close(zl.grad, jgrads[2], err_msg="d zl")
    ref_grads = state_dict_from_jax({"params": jgrads[0]}, tmod)
    for name, p in tmod.named_parameters():
        assert_close(p.grad, ref_grads[name], err_msg=f"d {name}")
    if stage == "bi":  # the lower block is stopped: its route logits take no gradient
        assert float(lg.grad[:, :3].abs().max()) == 0.0
        assert float(lg.grad[:, 3:6].abs().max()) > 0.0


def test_loss_based_fuse_and_weights():
    logits = _x(B, 7, 3, seed=100)
    for ema in (np.zeros(7, np.float32), np.abs(_x(7, seed=101))):
        for alpha in (1.0, 5.0):
            ref = js.loss_based_fuse(jnp.asarray(logits), jnp.asarray(ema), alpha, ROUTES7)
            got = ts.loss_based_fuse(t(logits), t(ema), alpha, ROUTES7)
            _close_tree(tuple(got), tuple(ref))
            _close_tree(ts.loss_based_route_weights(t(ema), alpha, ROUTES7),
                        js.loss_based_route_weights(jnp.asarray(ema), alpha, ROUTES7))


def test_block_mask_for_stage():
    for tax in ("7", "10"):
        routes = jroutes.get_routes(tax)
        for stage in ("uni", "bi", "tri"):
            _close_tree(troutes.block_mask_for_stage(stage, routes), jroutes.block_mask_for_stage(stage, routes))
    with pytest.raises(ValueError, match="stage"):
        troutes.block_mask_for_stage("step1", ROUTES7)


# --- the fairness losses --------------------------------------------------------

@pytest.mark.parametrize("groups", ["mixed", "one-group"])
def test_fairness_losses_and_two_class_ce(groups):
    rng = np.random.default_rng(7)
    probs = rng.random(12).astype(np.float32)
    y = (rng.random(12) > 0.5).astype(np.float32)
    g = rng.integers(0, 2, 12).astype(np.int32) if groups == "mixed" else np.zeros(12, np.int32)
    for tfn, jfn in ((tl.eddi_loss, jl.eddi_loss), (tl.soft_eq_odds_loss, jl.soft_eq_odds_loss)):
        p = t(probs).requires_grad_()
        got = tfn(p, t(y), t(g))
        ref, jgrad = jax.value_and_grad(lambda q: jfn(q, jnp.asarray(y), jnp.asarray(g)))(jnp.asarray(probs))
        assert_close(got, ref)
        got.backward()
        assert_close(p.grad, jgrad)
    logits = _x(12, 2, seed=8)
    for s in (0.0, 0.1):
        assert_close(tl.ce_two_class(t(logits), t(y), s), jl.ce_two_class(jnp.asarray(logits), jnp.asarray(y), s))
