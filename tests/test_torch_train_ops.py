"""The PyTorch port's training pieces against the JAX package on the CPU:
the plain version of K2 (the packed attention's backward) against the VJP of
JAX's ``_xla_attention``, the autograd Functions of K1/K2 and K3, the poly
GELU's gradient, the loss terms, BatchNorm in train mode, dropout and the
optimizer with its finite guard. Kernels on the card: tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.ops import capsule as jcap
from multimodalrouting_tpu.ops import gelu as jgelu
from multimodalrouting_tpu.ops.flash_packed import _xla_attention
from multimodalrouting_tpu.train import losses as jlosses
from multimodalrouting_tpu.train import state as jstate
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.models.cxr import BatchNorm
from multimodalrouting_tpu_torch.models.layers import dropout
from multimodalrouting_tpu_torch.ops import gelu as tgelu
from multimodalrouting_tpu_torch.ops.flash_packed import (
    packed_attention,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from multimodalrouting_tpu_torch.ops.fused_capsule import FusedCapsuleRouting, capsule_routing_reference
from multimodalrouting_tpu_torch.train import losses as tlosses
from multimodalrouting_tpu_torch.train.state import apply_gradients, create_train_state
from tests.torch_parity import assert_close, t

RTOL, ATOL = 2e-4, 2e-5  # fp32, as tests/test_pallas.py holds the packed backward


def _attn_inputs(n, tt, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    q = (rng.normal(size=(n, tt, d)) * dh**-0.5).astype(np.float32)
    k, v, do = (rng.normal(size=(n, tt, d)).astype(np.float32) for _ in range(3))
    valid = np.ones((n, tt), np.float32)
    valid[0, 190:] = 0.0  # ragged pad tail
    valid[1, :] = 0.0  # all-pad chunk: uniform attention, finite gradients
    return q, k, v, valid, do


@pytest.mark.parametrize("h,dh", [(4, 64), (2, 128)])
def test_packed_attention_bwd_reference_matches_jax_vjp(h, dh):
    """Plain K2 == jax.vjp of the XLA attention the JAX package's backward
    falls back to, on every row (pad queries carry a nonzero cotangent)."""
    q, k, v, valid, do = _attn_inputs(2, 256, h, dh, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, jnp.asarray(valid), h), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    got = packed_attention_bwd_reference(t(q), t(k), t(v), t(valid), t(do), h)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g).all(), name
        assert_close(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


def test_packed_attention_function_matches_autograd_through_plain():
    """On CPU tensors the K1/K2 autograd Function (plain forward, plain
    backward) gives the gradients of autograd through the plain forward."""
    q, k, v, valid, do = _attn_inputs(2, 256, 4, 64, seed=2)
    grads = []
    for fn in (packed_attention, packed_attention_reference):
        leaves = [t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, t(valid), 4)
        grads.append(torch.autograd.grad(out, leaves, t(do)))
    for name, g, r in zip(("dq", "dk", "dv"), *grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, msg=name)


def test_capsule_function_gradient_matches_jax_vjp():
    """K3's autograd Function (plain forward on the CPU, VJP of the plain
    program backward) == jax.vjp of ops/capsule.py:capsule_routing."""
    rng = np.random.default_rng(3)
    b, n, a, m, d = 4, 10, 32, 2, 64
    pose = rng.normal(size=(b, n, a)).astype(np.float32)
    act = (rng.random((b, n)) > 0.3).astype(np.float32)
    w = (np.sqrt(m / (a * n)) * rng.normal(size=(n, a, m, d))).astype(np.float32)
    cot = [rng.normal(size=s).astype(np.float32) for s in ((b, m, d), (b, m), (b, n, m))]

    def jfn(p, ww):
        out = jcap.capsule_routing(p, jnp.asarray(act), ww, 3, mode="softmax_out", act_type="ONES")
        return out.pose, out.act, out.coef

    _, vjp = jax.vjp(jfn, jnp.asarray(pose), jnp.asarray(w))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    tp, tw = t(pose).requires_grad_(), t(w).requires_grad_()
    outs = FusedCapsuleRouting.apply(tp, t(act), tw, 3)
    for o, r in zip(outs, capsule_routing_reference(t(pose), t(act), t(w), 3)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    got = torch.autograd.grad([o for o in outs if o.requires_grad], (tp, tw),
                              [t(c) for o, c in zip(outs, cot) if o.requires_grad])
    for name, g, r in zip(("pose", "w"), got, ref):
        assert_close(g, r, rtol=1e-4, atol=1e-5, err_msg=name)


def test_gelu_poly_gradient_matches_jax_and_saves_only_the_input():
    """The derivative of the same polynomial that jax.grad differentiates.
    2e-5: both are fp32 evaluations of q + 2u q'(u), which cancels near
    |x| = 3 sqrt(2) (each is ~8e-5 from the float64 value there)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([np.linspace(-6, 6, 4001), rng.normal(size=4000) * 3]).astype(np.float32)
    ref = jax.grad(lambda a: jgelu.gelu_poly(a).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: saved.append(s) or s, lambda s: s):
        y = tgelu.apply_gelu(xt, "poly")
    assert len(saved) == 1 and saved[0] is xt  # the input only: no fp32 chain kept
    (g,) = torch.autograd.grad(y.sum(), xt)
    assert_close(g, ref, rtol=2e-5, atol=2e-5)
    # the Function's forward is the serving chain, bit for bit
    torch.testing.assert_close(y.detach(), tgelu.gelu_poly(t(x)), rtol=0, atol=0)
    # bf16 in, bf16 gradient out
    xb = t(x).to(torch.bfloat16).requires_grad_()
    (gb,) = torch.autograd.grad(tgelu.gelu_poly(xb).float().sum(), xb)
    assert gb.dtype == torch.bfloat16 and torch.isfinite(gb.float()).all()


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits2 = rng.normal(size=(8, 2)).astype(np.float32) * 2
    y = (rng.random(8) > 0.6).astype(np.float32)
    ym = (rng.random((8, 5)) > 0.7).astype(np.float32)
    lm = rng.normal(size=(8, 5)).astype(np.float32) * 3
    sw = (rng.random(8) > 0.3).astype(np.float32)
    j, tt = jnp.asarray, t
    cases = [
        (tlosses.death_logit(tt(logits2)), jlosses.death_logit(j(logits2))),
        (tlosses.clamped_pos_weight(tt(ym)), jlosses.clamped_pos_weight(j(ym))),
        (tlosses.bce_with_logits(tt(lm), tt(ym), pos_weight=tlosses.clamped_pos_weight(tt(ym)), label_smoothing=0.05),
         jlosses.bce_with_logits(j(lm), j(ym), pos_weight=jlosses.clamped_pos_weight(j(ym)), label_smoothing=0.05)),
        (tlosses.bce_with_logits(tt(lm), tt(ym), sample_weight=tt(sw), reduce=False),
         jlosses.bce_with_logits(j(lm), j(ym), sample_weight=j(sw), reduce=False)),
        (tlosses.bce_with_logits(tt(lm[:, 0]), tt(y), sample_weight=tt(sw)),
         jlosses.bce_with_logits(j(lm[:, 0]), j(y), sample_weight=j(sw))),
        (tlosses.focal_bce_with_logits(tt(lm), tt(ym), gamma=2.0, alpha=0.3),
         jlosses.focal_bce_with_logits(j(lm), j(ym), gamma=2.0, alpha=0.3)),
    ]
    r = rng.dirichlet(np.ones(10), size=(8, 2)).transpose(0, 2, 1).astype(np.float32)
    rm = (rng.random((8, 10)) > 0.3).astype(np.float32)
    for kw in (dict(entropy_bonus=0.1), dict(uniform_penalty=0.2), dict(entropy_bonus=0.1, uniform_penalty=0.2), {}):
        cases.append((tlosses.routing_regularizers(tt(r), tt(rm), **kw), jlosses.routing_regularizers(j(r), j(rm), **kw)))
    cases.append((tlosses.routing_regularizers(tt(r), None, uniform_penalty=0.2),
                  jlosses.routing_regularizers(j(r), None, uniform_penalty=0.2)))
    for i, (got, ref) in enumerate(cases):
        assert_close(got, ref, rtol=1e-5, atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_flax(dtype):
    """Batch statistics, flax's running-statistics rule (momentum 0.9, the
    biased variance), and the buffers untouched by the forward itself."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(5, 6, 7, 16)) * 2 + 0.5).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    mean0, var0 = rng.normal(size=16).astype(np.float32) * 0.1, rng.uniform(0.5, 1.5, 16).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    ref, upd = bn.apply(variables, jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
    mod = BatchNorm(16, dtype)
    with torch.no_grad():
        mod.weight.copy_(t(scale)), mod.bias.copy_(t(bias))
        mod.running_mean.copy_(t(mean0)), mod.running_var.copy_(t(var0))
    got = mod(t(x).permute(0, 3, 1, 2).to(dtype), train=True).permute(0, 2, 3, 1)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1 / 64, atol=1 / 64)
    assert got.dtype == dtype
    assert_close(got, np.asarray(ref, np.float32), **tol)
    new_mean, new_var = mod.batch_update
    assert_close(new_mean, upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-6)
    assert_close(new_var, upd["batch_stats"]["var"], rtol=1e-5, atol=1e-6)
    assert_close(mod.running_mean, mean0, rtol=0, atol=0)
    assert_close(mod.running_var, var0, rtol=0, atol=0)


def test_dropout_keeps_rescales_and_reproduces():
    x = torch.linspace(1.0, 2.0, 200_000)
    a = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(a[kept], x[kept] / 0.9)
    torch.testing.assert_close(dropout(x, 0.1, torch.Generator().manual_seed(0)), a, rtol=0, atol=0)
    assert not torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(1)), a)
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, torch.Generator()) is x  # inference / rate 0
    xb = x.to(torch.bfloat16)
    assert dropout(xb, 0.1, torch.Generator().manual_seed(0)).dtype == torch.bfloat16


class _Tree(torch.nn.Module):
    """encoders.bbert.bert.w (frozen unless fine-tuned), encoders.behrt.w
    (encoder LR), head.w and head.b (head LR)."""

    def __init__(self, p):
        super().__init__()
        mods = {}
        for name, value in p.items():
            *path, leaf = name.split(".")
            parent = self
            for i, part in enumerate(path):
                key = ".".join(path[: i + 1])
                if key not in mods:
                    mods[key] = torch.nn.Module()
                    setattr(parent, part, mods[key])
                parent = mods[key]
            setattr(parent, leaf, torch.nn.Parameter(t(value)))


def test_apply_gradients_matches_jax_with_frozen_leaf_and_nonfinite_step():
    """Six steps of the hand-written optimizer against the JAX package's
    optax chain + apply_gradients: clip by the trainable leaves' global norm,
    Adam, decoupled decay, encoder/head learning rates, EMA, a frozen leaf,
    and a non-finite gradient at step 3 that skips everything but `step`."""
    rng = np.random.default_rng(7)
    shapes = {"encoders.bbert.bert.w": (6, 5), "encoders.behrt.w": (4, 3), "head.w": (3, 2), "head.b": (2,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.05 if i % 2 else 0.5)).astype(np.float32) for k, s in shapes.items()}
             for i in range(6)]
    grads[2]["head.w"][0, 0] = np.nan

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *path, leaf = k.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
        return out

    fp32 = {"model.dtype": "float32"}  # the frozen body stays fp32 at rest
    jtr = jstate.create_train_state(jc.apply_overrides(jc.Config(), fp32), type("M", (), {"apply": None})(),
                                    {"params": nest(p0)})
    model = _Tree(p0)
    model.head.register_buffer("running_mean", torch.zeros(2))
    state = create_train_state(tc.apply_overrides(tc.Config(), fp32), model)
    assert state.names == ["encoders.behrt.w", "head.w", "head.b"]  # the frozen body takes no moments
    for i, g in enumerate(grads):
        jtr, finite = jstate.apply_gradients(jtr, nest(g), lr_head=jnp.asarray(2e-4), lr_enc=jnp.asarray(5e-5),
                                             ema_decay=0.9)
        ok = apply_gradients(state, {k: t(v) for k, v in g.items()}, lr_head=2e-4, lr_enc=5e-5, ema_decay=0.9,
                             new_batch_stats={"head.running_mean": torch.full((2,), float(i + 1))})
        assert ok == bool(finite) == (i != 2)
        # BatchNorm statistics are committed with a finite step only
        assert model.head.running_mean[0].item() == (i if i == 2 else i + 1)
    assert state.step == int(jtr.step) == 6 and state.count == 5
    adam = jtr.opt_state.inner_states["train"].inner_state[1]
    assert int(adam.count) == 5
    params = dict(model.named_parameters())
    for name in shapes:
        path = name.split(".")
        jp, je = jtr.params, jtr.ema_params
        for part in path:
            jp, je = jp[part], je[part]
        assert_close(params[name], jp, rtol=5e-4, atol=1e-7, err_msg=name)
        if name in state.names:
            assert_close(state.ema[name], je, rtol=5e-4, atol=1e-7, err_msg=f"ema {name}")
            mu, nu = adam.mu, adam.nu
            for part in path:
                mu, nu = mu[part], nu[part]
            assert_close(state.mu[name], mu, rtol=5e-4, atol=1e-9, err_msg=f"mu {name}")
            assert_close(state.nu[name], nu, rtol=5e-4, atol=1e-12, err_msg=f"nu {name}")
        else:
            assert_close(params[name], p0[name], rtol=0, atol=0)  # frozen: never moves
