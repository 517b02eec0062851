"""The PyTorch port's ops against the JAX package on the CPU: GELU, LayerNorm,
masked ops, the plain versions of the two Hopper kernels (K1 packed
attention, K3 fused capsule routing) against the Pallas kernels in interpret
mode, and capsule routing in every mode. The kernels themselves are held
against these plain versions on the card in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodalrouting_tpu.ops import capsule as jcap
from multimodalrouting_tpu.ops import gelu as jgelu
from multimodalrouting_tpu.ops import layernorm as jln
from multimodalrouting_tpu.ops import masked as jmasked
from multimodalrouting_tpu.ops.flash_packed import packed_flash_self_attention
from multimodalrouting_tpu.ops.pallas_capsule import capsule_routing_pallas
from multimodalrouting_tpu_torch.ops import capsule as tcap
from multimodalrouting_tpu_torch.ops import gelu as tgelu
from multimodalrouting_tpu_torch.ops import layernorm as tln
from multimodalrouting_tpu_torch.ops import masked as tmasked
from multimodalrouting_tpu_torch.ops.flash_packed import (
    packed_attention,
    packed_attention_reference,
    supports_packed,
)
from multimodalrouting_tpu_torch.ops.fused_capsule import (
    capsule_routing_fused,
    capsule_routing_reference,
)
from tests.torch_parity import assert_close, t


def test_gelu_poly_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-6, 6, 4001), rng.normal(size=4000) * 3]).astype(np.float32)
    assert_close(tgelu.gelu_poly(t(x)), jgelu.gelu_poly(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    for mode in ("erf", "tanh"):
        ref = jgelu.apply_gelu(jnp.asarray(x), mode)
        assert_close(tgelu.apply_gelu(t(x), mode), ref, rtol=1e-5, atol=1e-6, err_msg=mode)


def test_layer_norms_match_jax():
    rng = np.random.default_rng(1)
    x32 = (rng.normal(size=(8, 33, 768)) * 5.0 - 1.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(768,)).astype(np.float32)
    bias = (rng.normal(size=(768,)) * 0.2).astype(np.float32)
    # bf16 FastLayerNorm against the JAX one; 1/64 as tests/test_layernorm.py
    xb = jnp.asarray(x32, jnp.bfloat16)
    ref = jln.fast_layer_norm(xb, jnp.asarray(scale), jnp.asarray(bias), 1e-12)
    got = tln.fast_layer_norm(t(x32).to(torch.bfloat16), t(scale), t(bias), 1e-12)
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(ref, np.float32), rtol=1.0 / 64, atol=1.0 / 64)
    # fp32: the flax chain
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref32 = fnn.LayerNorm(epsilon=1e-5).apply(v, jnp.asarray(x32))
    got32 = tln.layer_norm(t(x32), t(scale), t(bias), 1e-5, torch.float32)
    assert_close(got32, ref32, rtol=1e-5, atol=1e-5)


def test_masked_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    mask = (rng.random((4, 6)) > 0.4).astype(np.float32)
    mask[1] = 0.0  # empty row
    for name in ("masked_mean", "masked_max"):
        assert_close(getattr(tmasked, name)(t(x), t(mask)), getattr(jmasked, name)(x, mask), err_msg=name)
    assert_close(tmasked.masked_last(t(x), t(mask)), jmasked.masked_last(x, mask))
    logits = rng.normal(size=(4, 6)).astype(np.float32)
    assert_close(tmasked.masked_softmax(t(logits), t(mask)), jmasked.masked_softmax(logits, mask))


def _attn_inputs(b, tt, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    q = (rng.normal(size=(b, tt, d)) * dh**-0.5).astype(np.float32)
    k = rng.normal(size=(b, tt, d)).astype(np.float32)
    v = rng.normal(size=(b, tt, d)).astype(np.float32)
    valid = np.ones((b, tt), np.float32)
    valid[0, 190:] = 0.0  # ragged pad tail
    valid[1, :] = 0.0  # all-pad chunk: uniform attention, finite
    return q, k, v, valid


@pytest.mark.parametrize("h,dh", [(2, 64), (1, 128)])
def test_packed_attention_plain_matches_pallas_kernel(h, dh):
    """K1's plain version == the TPU kernel in interpret mode, every row."""
    q, k, v, valid = _attn_inputs(2, 256, h, dh, seed=3)
    ref = packed_flash_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), h, interpret=True
    )
    got = packed_attention_reference(t(q), t(k), t(v), t(valid), h)
    assert torch.isfinite(got).all()
    assert_close(got, ref)
    # the wrapper takes the plain version for CPU tensors, and only then
    torch.testing.assert_close(packed_attention(t(q), t(k), t(v), t(valid), h), got, rtol=0, atol=0)


def test_packed_gate_matches_jax():
    from multimodalrouting_tpu.ops import flash_packed as jfp

    for args in [(256, 256, 64, 768, 12), (512, 512, 64, 768, 12), (128, 128, 64, 768, 12),
                 (256, 256, 64, 192, 3), (256, 256, 128, 256, 2), (1024, 1024, 32, 256, 8),
                 (384, 384, 64, 768, 12), (2048, 2048, 64, 768, 12)]:
        assert supports_packed(*args) == jfp.supports_packed(*args), args


def _capsule_inputs(b, n, a, m, d, seed, act_kind):
    rng = np.random.default_rng(seed)
    pose = rng.normal(size=(b, n, a)).astype(np.float32)
    if act_kind == "ones":
        act = np.ones((b, n), np.float32)
    elif act_kind == "route_mask":
        act = (rng.random((b, n)) > 0.3).astype(np.float32)
        act[0] = 1.0
    else:
        act = rng.uniform(0.1, 0.9, size=(b, n)).astype(np.float32)
    w = (np.sqrt(m / (a * n)) * rng.normal(size=(n, a, m, d))).astype(np.float32)
    return pose, act, w


@pytest.mark.parametrize("act_kind", ["ones", "route_mask"])
def test_capsule_plain_matches_pallas_kernel(act_kind):
    """K3's plain version == the TPU kernel in interpret mode (flagship widths)."""
    pose, act, w = _capsule_inputs(4, 10, 32, 2, 64, seed=4, act_kind=act_kind)
    ref = capsule_routing_pallas(jnp.asarray(pose), jnp.asarray(act), jnp.asarray(w), 3, True)
    got = capsule_routing_reference(t(pose), t(act), t(w), 3)
    for g, r, name in zip(got, ref, ("pose", "act", "coef")):
        assert_close(g, r, rtol=1e-5, atol=1e-6, err_msg=name)
    for g, c in zip(capsule_routing_fused(t(pose), t(act), t(w), 3), got):
        torch.testing.assert_close(g, c, rtol=0, atol=0)


@pytest.mark.parametrize("act_kind", ["ones", "route_mask"])
@pytest.mark.parametrize(
    "b,m,dtype",
    [(4, 2, torch.bfloat16), (3, 25, torch.float32), (3, 25, torch.bfloat16)],
    ids=["mortality-bf16", "phenotype-fp32", "phenotype-bf16"],
)
def test_capsule_plain_matches_pallas_kernel_at_both_heads(b, m, dtype, act_kind):
    """K3's plain version == the TPU kernel in interpret mode at the
    phenotype head's widths (M = 25) and with bf16 inputs (the model's
    dtype: the TPU kernel gets the same bf16-rounded values in fp32, as both
    cast to fp32 on load). Tolerance 1e-5 + 1e-5 |ref|, K3's on the card: at
    M = 25 pose entries near 0 take absolute differences of a few 1e-6 from
    sums taken in another order."""
    pose, act, w = _capsule_inputs(b, 10, 32, m, 64, seed=4, act_kind=act_kind)
    tp, ta, tw = (t(x).to(dtype) for x in (pose, act, w))
    pose, act, w = (x.float().numpy() for x in (tp, ta, tw))
    ref = capsule_routing_pallas(jnp.asarray(pose), jnp.asarray(act), jnp.asarray(w), 3, True)
    got = capsule_routing_reference(tp, ta, tw, 3)
    for g, r, name in zip(got, ref, ("pose", "act", "coef")):
        assert g.dtype == torch.float32
        assert_close(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
    for g, c in zip(capsule_routing_fused(tp, ta, tw, 3), got):
        torch.testing.assert_close(g, c, rtol=0, atol=0)


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="softmax_out"),
        dict(mode="softmax_out", act_type="EM"),
        dict(mode="sigmoid_routes", gate_temp=0.7, gate_min=0.05, gate_max=0.95),
        dict(mode="uniform"),
        dict(mode="softmax_out", uniform_routing=True),
        dict(mode="sigmoid_routes", uniform_routing=True),
    ],
)
def test_capsule_routing_modes_match_jax(kw):
    pose, act, w = _capsule_inputs(3, 7, 8, 5, 16, seed=5, act_kind="uniform")
    ref = jcap.capsule_routing(jnp.asarray(pose), jnp.asarray(act), jnp.asarray(w), 3, **kw)
    got = tcap.capsule_routing(t(pose), t(act), t(w), 3, **kw)
    for g, r, name in zip(got, ref, ("pose", "act", "coef")):
        assert_close(g, r, rtol=1e-5, atol=1e-6, err_msg=f"{kw} {name}")
    mask = (np.random.default_rng(6).random((3, 7)) > 0.3).astype(np.float32)
    assert_close(
        tcap.route_given_label(got.coef, t(mask)),
        jcap.route_given_label(ref.coef, jnp.asarray(mask)),
        rtol=1e-5, atol=1e-6,
    )


def test_capsule_dropout_drops_and_rescales():
    """Decision-pose dropout: with one iteration every surviving entry is the
    undropped pose over keep_p, the rest are 0, about `rate` of them."""
    pose, act, w = _capsule_inputs(64, 7, 8, 5, 16, seed=7, act_kind="uniform")
    clean = tcap.capsule_routing(t(pose), t(act), t(w), 1)
    gen = torch.Generator().manual_seed(0)
    dropped = tcap.capsule_routing(t(pose), t(act), t(w), 1, dropout_rate=0.25, generator=gen)
    kept = dropped.pose != 0
    assert 0.6 < kept.float().mean().item() < 0.9
    torch.testing.assert_close(dropped.pose[kept], clean.pose[kept] / 0.75)
    # no generator (inference): no dropout
    torch.testing.assert_close(
        tcap.capsule_routing(t(pose), t(act), t(w), 1, dropout_rate=0.25).pose, clean.pose
    )


def test_ctypes_signatures_match_the_cuda_sources():
    """Every extern "C" function of csrc/*.cu is declared to ctypes with the
    same argument and return types (a mismatch would pass truncated pointers
    to the kernels, which only a run on the card could show)."""
    import ctypes
    import os
    import re

    from multimodalrouting_tpu_torch.ops import hopper

    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for lib, functions in hopper._SIGNATURES.items():
        with open(os.path.join(hopper.CSRC_DIR, f"{lib}.cu")) as f:
            src = f.read()
        exported = {
            name: (ret, args)
            for ret, name, args in re.findall(r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src)
        }
        assert set(exported) == set(functions), lib
        for name, (restype, argtypes) in functions.items():
            ret, args = exported[name]
            params = [" ".join(a.split()[:-1]) for a in args.replace("\n", " ").split(",")]
            want = [ctypes.c_void_p if "*" in p else c_types[p.replace("const ", "")] for p in params]
            assert argtypes == want, name
            assert restype == c_types[ret], name


def test_k3_phase_clocks_finds_every_phase_mark_in_the_kernel_source():
    """scripts/k3_phase_clocks.py instruments K3's source at fixed lines;
    each must stand exactly once in csrc/capsule_routing.cu (an edit that
    moves one would show only on the card)."""
    import importlib.util
    import os

    from multimodalrouting_tpu_torch.ops import hopper

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("k3_phase_clocks", os.path.join(root, "scripts", "k3_phase_clocks.py"))
    clocks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clocks)
    with open(os.path.join(hopper.CSRC_DIR, "capsule_routing.cu")) as f:
        out = clocks.instrumented_source(f.read())
    # the start, each phase, the outputs and the end
    assert out.count("  MARK\n") == len(clocks.MARKS) + 3
