"""The attention backward's di order on the CPU: K2 takes rowsum(dp * p) as
di = rowsum(o * do) from the forward's output (the di kernel that K2 and
K4's backward launch first). These hold that order against the TPU kernel
(the JAX package's packed backward in interpret mode), the plain di against
the TPU kernel's rowsum, and the K1/K2 autograd Function, which now saves its
output, against the gradients it gave before. The kernels themselves are
held against these plain versions on the card in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu.ops.flash_packed import _packed_bwd_call
from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops.flash_packed import (
    attention_bwd_di,
    attention_bwd_di_reference,
    packed_attention,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from tests.torch_parity import assert_close, t

RTOL, ATOL = 2e-4, 2e-5  # fp32, as tests/test_pallas.py holds the packed backward


def _inputs(n, tt, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    q = (rng.normal(size=(n, tt, d)) * dh**-0.5).astype(np.float32)
    k, v, do = (rng.normal(size=(n, tt, d)).astype(np.float32) for _ in range(3))
    valid = np.ones((n, tt), np.float32)
    valid[0, 190:] = 0.0  # ragged pad tail: pad queries carry a cotangent too
    valid[1, :] = 0.0  # all-pad chunk: uniform attention, finite gradients
    return q, k, v, valid, do


def _heads(x, h):
    return x.unflatten(2, (h, x.shape[2] // h))


@pytest.mark.parametrize("tt", [256, 512])
@pytest.mark.parametrize("h,dh", [(2, 64), (1, 128)])
def test_di_order_matches_tpu_kernel(tt, h, dh):
    """The port's backward with di = rowsum(o * do) from the plain di ==
    the TPU kernel (rowsum(dp * p) from fp32 p) in interpret mode, every row."""
    q, k, v, valid, do = _inputs(2, tt, h, dh, seed=tt + dh)
    ref = _packed_bwd_call(*map(jnp.asarray, (q, k, v, valid, do)), h, interpret=True)
    out = packed_attention_reference(t(q), t(k), t(v), t(valid), h)
    di = attention_bwd_di_reference(_heads(out, h), _heads(t(do), h))
    got = packed_attention_bwd_reference(t(q), t(k), t(v), t(valid), t(do), h, di=di)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g).all(), name
        assert_close(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("h,dh", [(2, 64), (1, 128)])
def test_di_reference_is_the_tpu_rowsum(h, dh):
    """rowsum(o * do) == rowsum(dp * p) (the TPU kernel's delta, fp32 p) on
    every row, the all-pad chunk's uniform rows included."""
    q, k, v, valid, do = (t(x) for x in _inputs(2, 256, h, dh, seed=7))
    out = packed_attention_reference(q, k, v, valid, h)
    qh, kh, vh, doh = (_heads(x, h) for x in (q, k, v, do))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) + ((1.0 - valid) * -1e30)[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    di = attention_bwd_di_reference(_heads(out, h), doh)
    assert di.shape == (2, h, 256) and di.dtype == torch.float32
    torch.testing.assert_close(di, (dp * p).sum(dim=-1), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_di_wrapper_runs_the_plain_version_on_cpu_tensors(dtype):
    """On CPU tensors the di wrapper is its plain version, in fp32, and
    launches nothing; strided views are read as they are."""
    rng = np.random.default_rng(4)
    fused = torch.from_numpy(rng.normal(size=(3, 256, 2 * 192)).astype(np.float32)).to(dtype)
    out, do = (_heads(x, 3) for x in fused.split(192, dim=-1))  # [3, 256, 3, 64] views, row stride 384
    before = attention_bwd_di.launches
    got = attention_bwd_di(out, do)
    assert attention_bwd_di.launches == before
    assert got.dtype == torch.float32 and got.shape == (3, 3, 256) and got.is_contiguous()
    want = (out.float() * do.float()).sum(dim=-1).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_attention_function_saves_its_output_and_keeps_its_gradients():
    """The K1/K2 Function saves its own output (the tensor the
    out-projection keeps, so no memory is added) beside q, k, v, the mask and
    the lse; on CPU tensors its gradients are still the plain backward in the
    TPU order, bit for bit."""
    q, k, v, valid, do = _inputs(2, 256, 4, 64, seed=2)
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = packed_attention(*leaves, t(valid), 4)
    assert out.grad_fn is not None and "PackedAttention" in type(out.grad_fn).__name__
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[5] is None  # no lse on the CPU
    assert saved[4].data_ptr() == out.data_ptr() and torch.equal(saved[4], out)
    got = torch.autograd.grad(out, leaves, t(do))
    want = packed_attention_bwd_reference(t(q), t(k), t(v), t(valid), t(do), 4)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_attention_bwd_exports_are_declared():
    """The di kernel's own entry points and the backwards' new argument list
    (o and its strides) are declared to ctypes: 11 pointers, 4 ints, 12
    strides and the stream for each backward."""
    packed, flash = hopper._SIGNATURES["packed_attention_bwd"], hopper._SIGNATURES["flash_attention_bwd"]
    assert {"attention_bwd_di_bf16", "attention_bwd_di_f32"} <= set(packed)
    for name, (_, args) in {**packed, **flash}.items():
        if name.startswith("attention_bwd_di"):
            assert len(args) == 3 + 4 + 4 + 1, name
        else:
            assert len(args) == 11 + 4 + 12 + 1, name
