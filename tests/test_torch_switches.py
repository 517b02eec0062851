"""The port's debug checks, ``StepTimer`` and the two attention switches
against the JAX package on the CPU:

- ``StepTimer.summary()`` equals the JAX class's on one patched clock, and
  ``checked_finite`` prints the JAX message (``MMR_DEBUG_CHECKS=1``) or
  nothing (flag off), returning its input;
- ``MMR_PACKED_BWD=xla``: on CPU tensors ``PackedAttention``'s backward is
  autograd's VJP of the plain attention, bit for bit, and K2's wrapper is
  not called; on a CUDA tensor the switch raises; the
  gradients equal JAX ``packed_flash_self_attention``'s (its forward kernel
  in interpret mode) under the same switch at rtol 1e-6 and atol 2e-6
  (``VJP_ATOL``). tests/test_pallas.py holds the JAX fallback to its own
  XLA VJP at 1e-6 / 1e-7, one library against itself; torch's and XLA's
  fp32 products of the same VJP differed here by at most 2.9e-6 (dq, of
  magnitude up to ~10; dk and dv 5.4e-7), and an atol of 1e-7 fails 1-2%
  of the elements, those near zero;
- ``MMR_FUSED_QKV=1``: self-attention's k and v from one product over
  their concatenated weights, q from its own, give the unfused output and
  gradients bit for bit (atol 0, as
  tests/test_fused_qkv.py holds the JAX module; torch's CPU GEMM gave no
  difference in the last bit at these shapes), and the JAX module's fused
  output at the port's usual fp32 parity tolerance (2e-4 / 2e-5: two
  libraries' GEMMs); cross-attention does not fuse; in the tiny flagship
  every self-attention site the JAX package fuses (BERT, BEHRT, the MulT
  self streams) fuses, no cross-attention site does, and the forward is
  unchanged.
"""
import io
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu.models import attention as jattn
from multimodalrouting_tpu.ops import flash_packed as jfp
from multimodalrouting_tpu.utils import debug as jdebug
from multimodalrouting_tpu.utils import profiling as jprofiling
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.models import attention as tattn
from multimodalrouting_tpu_torch.models import transformer as ttransformer
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import flash_packed
from multimodalrouting_tpu_torch.utils import StepTimer, annotate, checked_finite, debug_checks_enabled, trace_context
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import assert_close, jitter, one_torch_thread, t, torch_batch  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VJP_ATOL = 2e-6  # torch's VJP against XLA's: see the docstring


# --- (a) StepTimer and the debug checks -------------------------------------


def test_step_timer_summary_equals_jax(monkeypatch):
    summaries = []
    for timer in (StepTimer(warmup=2), jprofiling.StepTimer(warmup=2)):
        ticks = iter(np.cumsum(np.random.default_rng(0).random(18)).tolist())  # one clock for each
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        assert timer.summary() == {"steps": 0}
        for _ in range(9):
            with timer:
                pass
        summaries.append(timer.summary())
    got, ref = summaries
    assert got == ref and got["steps"] == 7 and sorted(got) == ["mean_s", "p50_s", "p90_s", "p99_s", "steps",
                                                                 "total_s"]
    assert annotate and trace_context  # the package exports JAX's names and keeps its own


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
        jax.effects_barrier()
    return buf.getvalue()


@pytest.mark.parametrize("flag", ["1", "0", None])
def test_checked_finite_prints_the_jax_message(flag, monkeypatch):
    if flag is None:
        monkeypatch.delenv("MMR_DEBUG_CHECKS", raising=False)
    else:
        monkeypatch.setenv("MMR_DEBUG_CHECKS", flag)
    assert debug_checks_enabled() == jdebug.debug_checks_enabled() == (flag == "1")
    bad = np.array([1.0, np.nan, 2.0], np.float32)
    for x in (bad, np.ones(3, np.float32), np.array([np.inf], np.float32)):
        tx = torch.from_numpy(x)
        returned = []
        got = _printed(lambda: returned.append(checked_finite(tx, "h_text")))
        ref = _printed(lambda: jax.jit(lambda a: jdebug.checked_finite(a, "h_text"))(jnp.asarray(x)))
        assert got == ref and returned[0] is tx
        assert (got == "[MMR_DEBUG] non-finite values in h_text\n") == (flag == "1" and not np.isfinite(x).all())


def test_checked_finite_does_no_device_work_when_off(monkeypatch):
    monkeypatch.delenv("MMR_DEBUG_CHECKS", raising=False)
    monkeypatch.setattr(torch, "isfinite", lambda x: pytest.fail("checked the values with the flag off"))
    x = torch.tensor([np.nan])
    assert checked_finite(x, "x") is x


# --- (b) MMR_PACKED_BWD -----------------------------------------------------


def _packed_inputs(h, dh, seed=7):
    """tests/test_pallas.py's packed-backward inputs: a ragged key pad, pad
    query rows with a zero cotangent."""
    rng = np.random.default_rng(seed)
    b, tt = 2, 256
    d = h * dh
    q = (rng.normal(size=(b, tt, d)) * dh**-0.5).astype(np.float32)
    k, v, ct = (rng.normal(size=(b, tt, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, tt), np.float32)
    mask[0, 190:] = 0.0
    return q, k, v, mask, ct * mask[:, :, None]


def _port_grads(q, k, v, mask, ct, h):
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    flash_packed.packed_attention(*qkv, t(mask), h).backward(t(ct))
    return [x.grad for x in qkv]


@pytest.mark.parametrize("h,dh", [(4, 64), (2, 128)])
def test_packed_bwd_xla_is_the_plain_vjp_and_jax_s(h, dh, monkeypatch):
    q, k, v, mask, ct = _packed_inputs(h, dh)
    calls = []
    real = flash_packed.packed_attention_bwd
    monkeypatch.setattr(flash_packed, "packed_attention_bwd", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("MMR_PACKED_BWD", "xla")
    got = _port_grads(q, k, v, mask, ct, h)
    assert calls == []
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    flash_packed.packed_attention_reference(*qkv, t(mask), h).backward(t(ct))
    for g, r in zip(got, qkv):
        assert torch.equal(g, r.grad)
    _, vjp = jax.vjp(lambda a, b, c: jfp.packed_flash_self_attention(a, b, c, jnp.asarray(mask), h, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    for name, g, r in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=VJP_ATOL, err_msg=name)
    monkeypatch.setenv("MMR_PACKED_BWD", "pallas")
    _port_grads(q, k, v, mask, ct, h)
    monkeypatch.delenv("MMR_PACKED_BWD")
    _port_grads(q, k, v, mask, ct, h)
    assert calls == [1, 1]  # K2's wrapper by default and under pallas


def test_packed_bwd_xla_raises_on_the_card(monkeypatch):
    """On a CUDA tensor the switch raises (the port's backward there is K2);
    the default and ``pallas`` select K2 on every device. Only the device's
    type is read, so no card is needed."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for value in (None, "pallas"):
        if value is None:
            monkeypatch.delenv("MMR_PACKED_BWD", raising=False)
        else:
            monkeypatch.setenv("MMR_PACKED_BWD", value)
        assert flash_packed.packed_bwd_impl(cuda) == flash_packed.packed_bwd_impl(cpu) == "pallas"
    monkeypatch.setenv("MMR_PACKED_BWD", "xla")
    assert flash_packed.packed_bwd_impl(cpu) == "xla"
    with pytest.raises(ValueError, match="on the card the port's packed backward is K2"):
        flash_packed.packed_bwd_impl(cuda)


# --- (b) MMR_FUSED_QKV ------------------------------------------------------


def _mha_pair(d=32, h=4, dtype=jnp.float32, seed=0):
    x = np.random.default_rng(seed).normal(size=(3, 7, d)).astype(np.float32)
    jm = jattn.MultiheadAttention(d=d, num_heads=h, dtype=dtype)
    variables = jitter(jm.init(jax.random.PRNGKey(seed), x, x, x), seed=seed, scale=0.1)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jm, variables, load_jax_variables(tattn.MultiheadAttention(d, h, dtype=tdtype), variables).eval()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_qkv_output_identical_and_jax_s(dtype, monkeypatch):
    rng = np.random.default_rng(1)
    jm, variables, tm = _mha_pair(dtype=dtype)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    mask = rng.integers(0, 2, size=(3, 7)).astype(np.float32)
    mask[:, 0] = 1.0
    tx, tmask = t(x), t(mask)
    with torch.no_grad():
        ref = tm(tx, tx, tx, kv_mask=tmask)
        monkeypatch.setenv("MMR_FUSED_QKV", "1")
        got = tm(tx, tx, tx, kv_mask=tmask)
    assert torch.equal(got, ref)
    jref = jm.apply(variables, x, x, x, kv_mask=mask)
    if dtype == jnp.float32:
        assert_close(got, jref)
    else:  # bf16 products in two libraries: a few bf16 ulps
        assert_close(got.float(), np.asarray(jref, np.float32), rtol=2e-2, atol=2e-2)


def test_fused_qkv_leaves_cross_attention_alone(monkeypatch):
    rng = np.random.default_rng(3)
    _, _, tm = _mha_pair(seed=4)
    q, kv = t(rng.normal(size=(2, 4, 32)).astype(np.float32)), t(rng.normal(size=(2, 6, 32)).astype(np.float32))
    with torch.no_grad():
        ref = tm(q, kv, kv)
        monkeypatch.setenv("MMR_FUSED_QKV", "1")
        monkeypatch.setattr(tattn, "fused_qkv", lambda *a: pytest.fail("cross-attention fused"))
        assert torch.equal(tm(q, kv, kv), ref)


def test_fused_qkv_gradients_flow(monkeypatch):
    _, _, tm = _mha_pair(seed=5)
    x = t(np.random.default_rng(5).normal(size=(2, 5, 32)).astype(np.float32))
    grads = []
    for flag in ("0", "1"):
        monkeypatch.setenv("MMR_FUSED_QKV", flag)
        tm.zero_grad()
        (tm(x, x, x) ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads[1].values())
    for name, g in grads[1].items():
        assert torch.equal(g, grads[0][name]), name


def test_fused_qkv_at_the_flagship_s_self_attention_sites(monkeypatch):
    """The tiny flagship (BERT at T = 16, BEHRT, the MulT streams): one
    fused product per BERT and BEHRT layer and per MulT self-stream layer,
    none at a cross-attention site, and the same forward bit for bit."""
    cfg = tc.apply_overrides(tc.Config(), {**TINY, "encoder.text_max_len": 16, "encoder.image_size": 32})
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu").eval()
    batch = torch_batch(tiny_batch(n=2, seed=1, missing_rate=0.25))
    with torch.no_grad():
        ref = model(batch)
    calls = {"mha": 0, "stacked": 0}
    for mod, name, key in ((tattn, "fused_qkv", "mha"), (ttransformer, "fused_stacked_qkv", "stacked")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, key=key: calls.__setitem__(key, calls[key] + 1) or real(*a))
    monkeypatch.setenv("MMR_FUSED_QKV", "1")
    with torch.no_grad():
        got = model(batch)
    e, m = cfg.encoder, cfg.model
    assert calls == {"mha": e.bert_layers + e.structured_layers, "stacked": m.mult_self_layers}
    for name in ("logits", "alpha", "r_matrix"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
