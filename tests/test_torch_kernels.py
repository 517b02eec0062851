"""The Hopper kernels against their plain versions, on the card: K1 (packed
attention), K2 (its backward) alone and through autograd, K3 (capsule
routing) and its autograd gradient, K4 (segment attention, the kernel pair
of K4a flash and K4b splash) forward and backward alone and through
autograd, with its two launch counters; the attention backward that K2 and
K4 share (the di kernel, then the dq and dk/dv kernels) on strided views,
repeated, the di kernel alone, and the shapes it refuses.

These need a CUDA card and the CUDA toolkit (the kernels are built from
multimodalrouting_tpu_torch/csrc/ at first use) and skip elsewhere. They
import neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    DI_TOL,
    K1_FP32_TOL,
    K2_FP32_TOL,
    K4_FP32_TOL,
    bf16_errors,
    describe_bf16,
    within_bf16_limits,
)
from multimodalrouting_tpu_torch.ops.capsule import capsule_weight_init
from multimodalrouting_tpu_torch.ops.flash import (
    flash_self_attention,
    segment_attention_bwd,
    segment_attention_bwd_reference,
    segment_attention_fwd,
    segment_attention_reference,
    splash_self_attention,
)
from multimodalrouting_tpu_torch.ops.flash_packed import (
    attention_bwd_di,
    attention_bwd_di_reference,
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_fwd,
    packed_attention_reference,
)
from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused, capsule_routing_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _attn_inputs(n, t, h, dh, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, t, h * dh)
    q = (torch.randn(shape, generator=g, device=dev) * dh**-0.5).to(dtype)
    k = torch.randn(shape, generator=g, device=dev).to(dtype)
    v = torch.randn(shape, generator=g, device=dev).to(dtype)
    valid = torch.ones((n, t), device=dev)
    valid[0, 190:] = 0.0  # ragged pad tail
    valid[1] = 0.0  # all-pad chunk: uniform attention, finite
    return q, k, v, valid


def _assert_close(got, ref, q, k, v, m, h):
    """K1's limits in chip_smoke.py, which says why they are what they are."""
    if q.dtype == torch.float32:
        atol, rtol = K1_FP32_TOL
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        return
    exact = packed_attention_reference(q.float(), k.float(), v.float(), m, h)
    errors = bf16_errors(got, ref, exact)
    assert within_bf16_limits(errors), describe_bf16(errors)


@pytest.mark.parametrize(
    "dtype,h,dh",
    [(torch.bfloat16, 12, 64), (torch.float32, 4, 64), (torch.bfloat16, 2, 128), (torch.float32, 2, 128)],
)
@pytest.mark.parametrize("t", [256, 512, 1024])
def test_packed_attention_kernel_matches_plain(cuda, dtype, h, dh, t):
    q, k, v, m = _attn_inputs(4, t, h, dh, dtype, cuda)
    before = packed_attention.launches
    with torch.no_grad():
        got = packed_attention(q, k, v, m, h)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert torch.isfinite(got).all()
    _assert_close(got, packed_attention_reference(q, k, v, m, h), q, k, v, m, h)


def test_packed_attention_kernel_reads_strided_views(cuda):
    """q, k, v as column slices of one fused [N, T, 3D] projection: the
    kernel reads the row-strided views in place."""
    n, t, h, dh = 3, 256, 4, 64
    d = h * dh
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((n, t, 3 * d), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    m = torch.ones((n, t), device=cuda)
    with torch.no_grad():
        got = packed_attention(q, k, v, m, h)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _assert_close(got, packed_attention_reference(q, k, v, m, h), q, k, v, m, h)


def test_packed_attention_kernel_refuses_grad(cuda):
    """Under a gradient the packed path needs the backward's gate, T <= 512:
    longer chunks are refused (their callers take the eager attention)."""
    q, k, v, m = _attn_inputs(2, 1024, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="T <= 512"):
        packed_attention(q.requires_grad_(), k, v, m, 2)


def _assert_bwd_close(got, q, k, v, m, do, h):
    """K2's limits in chip_smoke.py: K1's bf16 limits for each of dq, dk, dv."""
    ref = packed_attention_bwd_reference(q, k, v, m, do, h)
    if q.dtype == torch.float32:
        atol, rtol = K2_FP32_TOL
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
        return
    exact = packed_attention_bwd_reference(q.float(), k.float(), v.float(), m, do.float(), h)
    for name, g, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
        errors = bf16_errors(g, r, e)
        assert within_bf16_limits(errors), f"{name}: {describe_bf16(errors)}"


@pytest.mark.parametrize(
    "dtype,h,dh",
    [(torch.bfloat16, 12, 64), (torch.float32, 4, 64), (torch.bfloat16, 2, 128), (torch.float32, 2, 128)],
)
@pytest.mark.parametrize("t", [256, 512])
def test_packed_attention_bwd_kernel_matches_plain(cuda, dtype, h, dh, t):
    """K2 on every row (a cotangent on pad queries too), with a ragged and an
    all-pad chunk."""
    q, k, v, m = _attn_inputs(4, t, h, dh, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda).to(dtype)
    with torch.no_grad():
        out, lse = packed_attention_fwd(q, k, v, m, h, want_lse=True)
        before = packed_attention_bwd.launches
        got = packed_attention_bwd(q, k, v, m, out, lse, do, h)
    torch.cuda.synchronize()
    assert packed_attention_bwd.launches == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    _assert_bwd_close(got, q, k, v, m, do, h)


def test_packed_attention_autograd_matches_plain_autograd(cuda):
    """K1 forward + K2 backward through autograd, on column slices of a fused
    projection, against autograd through the plain forward."""
    n, t, h, dh = 3, 256, 4, 64
    d = h * dh
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((n, t, 3 * d), generator=g, device=cuda).to(torch.bfloat16).requires_grad_()
    m = torch.ones((n, t), device=cuda)
    m[1, 100:] = 0.0
    do = torch.randn((n, t, d), generator=g, device=cuda).to(torch.bfloat16)
    before = (packed_attention.launches, packed_attention_bwd.launches)
    (got,) = torch.autograd.grad(packed_attention(*qkv.split(d, dim=-1), m, h), qkv, do)
    assert (packed_attention.launches, packed_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    q, k, v = (x.detach().contiguous() for x in qkv.split(d, dim=-1))
    _assert_bwd_close(got.split(d, dim=-1), q, k, v, m, do, h)


@pytest.mark.parametrize("b,n,a,m,d", [(16, 10, 32, 2, 64), (5, 7, 8, 25, 16), (3, 10, 32, 1, 64)])
def test_capsule_kernel_matches_plain(cuda, b, n, a, m, d):
    rng = np.random.default_rng(2)
    pose = torch.from_numpy(rng.normal(size=(b, n, a)).astype(np.float32)).to(cuda)
    act = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.float32)).to(cuda)
    w = capsule_weight_init(n, a, m, d, torch.Generator().manual_seed(2)).to(cuda)
    before = capsule_routing_fused.launches
    with torch.no_grad():
        got = capsule_routing_fused(pose, act, w, 3)
    torch.cuda.synchronize()
    assert capsule_routing_fused.launches == before + 1
    for x, y in zip(got, capsule_routing_reference(pose, act, w, 3)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_capsule_kernel_gradient_matches_plain_autograd(cuda):
    """K3 forward under autograd, the plain program's VJP backward."""
    rng = np.random.default_rng(3)
    b, n, a, m, d = 16, 10, 32, 2, 64
    pose = torch.from_numpy(rng.normal(size=(b, n, a)).astype(np.float32)).to(cuda)
    act = torch.from_numpy((rng.random((b, n)) > 0.3).astype(np.float32)).to(cuda)
    w = capsule_weight_init(n, a, m, d, torch.Generator().manual_seed(3)).to(cuda)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda) for s in ((b, m, d), (b, n, m))]
    grads = []
    for fn in (capsule_routing_fused, capsule_routing_reference):
        p, ww = pose.clone().requires_grad_(), w.clone().requires_grad_()
        before = capsule_routing_fused.launches
        pose_out, _, coef = fn(p, act, ww, 3)
        grads.append(torch.autograd.grad((pose_out * cot[0]).sum() + (coef * cot[1]).sum(), (p, ww)))
        assert capsule_routing_fused.launches == before + (fn is capsule_routing_fused)
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_capsule_kernel_refuses_rows_beyond_shared_memory(cuda):
    """One row's votes must fit a block's 48 KB of shared memory."""
    pose = torch.zeros((2, 10, 32), device=cuda)
    act = torch.ones((2, 10), device=cuda)
    w = torch.zeros((10, 32, 25, 64), device=cuda)  # 10 x 25 x 64 fp32 votes = 64 KB
    with torch.no_grad(), pytest.raises(RuntimeError, match="capsule_routing of N=10, A=32, M=25, D=64"):
        capsule_routing_fused(pose, act, w, 3)


def _assert_k4_close(name, got, ref, exact, dtype):
    """K4's limits in chip_smoke.py: K1's bf16 limits per output, every row."""
    if dtype == torch.float32:
        atol, rtol = K4_FP32_TOL
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=name)
        return
    errors = bf16_errors(got, ref, exact)
    assert within_bf16_limits(errors), f"{name}: {describe_bf16(errors)}"


@pytest.mark.parametrize(
    "dtype,h,dh,t",
    [(torch.bfloat16, 3, 64, 256), (torch.float32, 3, 64, 256), (torch.bfloat16, 2, 128, 512),
     (torch.float32, 2, 128, 512), (torch.bfloat16, 3, 64, 1024), (torch.float32, 1, 64, 1024),
     (torch.bfloat16, 2, 128, 256), (torch.float32, 2, 128, 256), (torch.bfloat16, 3, 64, 512),
     (torch.float32, 3, 64, 512), (torch.bfloat16, 1, 128, 1024), (torch.float32, 1, 128, 1024)],
)
def test_segment_attention_kernels_match_plain(cuda, dtype, h, dh, t):
    """K4 forward and backward on every row (pad queries and an all-pad
    chunk included), odd head counts, each of T 256/512/1024 with dh 64 and
    128, bf16 and fp32."""
    q, k, v, m = _attn_inputs(4, t, h, dh, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda).to(dtype)
    q4, k4, v4, do4 = (x.unflatten(2, (h, dh)) for x in (q, k, v, do))
    with torch.no_grad():
        before = (flash_self_attention.launches, flash_self_attention.bwd_launches)
        out, lse = segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention)
        grads = segment_attention_bwd(q4, k4, v4, m, out, lse, do4, flash_self_attention)
    torch.cuda.synchronize()
    assert (flash_self_attention.launches, flash_self_attention.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)
    qf, kf, vf = q4.float(), k4.float(), v4.float()
    exact = segment_attention_reference(qf, kf, vf, m)
    _assert_k4_close("out", out, segment_attention_reference(q4, k4, v4, m), exact, dtype)
    exact_grads = segment_attention_bwd_reference(qf, kf, vf, m, exact, do4.float())
    for name, g, r, e in zip(("dq", "dk", "dv"), grads, segment_attention_bwd_reference(q4, k4, v4, m, out, do4),
                             exact_grads):
        _assert_k4_close(name, g, r, e, dtype)


@pytest.mark.parametrize("wrapper", [flash_self_attention, splash_self_attention])
def test_segment_attention_autograd_matches_plain_and_counts(cuda, wrapper):
    """K4 forward + backward through autograd on column slices of a fused
    projection, as [N, T, H, dh] views; each wrapper counts on its own
    counters only."""
    n, t, h, dh = 3, 256, 3, 64
    d = h * dh
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((n, t, 3 * d), generator=g, device=cuda).to(torch.bfloat16).requires_grad_()
    m = torch.ones((n, t), device=cuda)
    m[1, 100:] = 0.0
    m[2] = 0.0
    do = torch.randn((n, t, h, dh), generator=g, device=cuda).to(torch.bfloat16)
    other = splash_self_attention if wrapper is flash_self_attention else flash_self_attention
    before = (wrapper.launches, wrapper.bwd_launches, other.launches, other.bwd_launches)
    q4, k4, v4 = (x.unflatten(2, (h, dh)) for x in qkv.split(d, dim=-1))
    out = wrapper(q4, k4, v4, m)
    (got,) = torch.autograd.grad(out, qkv, do)
    assert (wrapper.launches, wrapper.bwd_launches, other.launches, other.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    q4, k4, v4 = (x.detach().contiguous().unflatten(2, (h, dh)) for x in qkv.split(d, dim=-1))
    ref = segment_attention_bwd_reference(q4, k4, v4, m, out.detach(), do)
    exact = segment_attention_reference(q4.float(), k4.float(), v4.float(), m)
    exact_grads = segment_attention_bwd_reference(q4.float(), k4.float(), v4.float(), m, exact, do.float())
    for name, x, r, e in zip(("dq", "dk", "dv"), got.split(d, dim=-1), ref, exact_grads):
        _assert_k4_close(name, x.unflatten(2, (h, dh)), r, e, torch.bfloat16)


def test_segment_attention_kernel_refuses_unsupported_shapes(cuda):
    """Outside the gate (T % 128, dh) the wrappers raise instead of
    launching; a head row that is not contiguous is refused too."""
    x = torch.zeros((2, 320, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = flash_self_attention.launches
    with torch.no_grad(), pytest.raises(ValueError, match="T=320"):
        flash_self_attention(x, x, x, None)
    y = torch.zeros((2, 256, 64, 2), device=cuda, dtype=torch.bfloat16).transpose(2, 3)  # [N, T, H=2, dh=64], dh strided
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        splash_self_attention(y, y, y, None)
    assert flash_self_attention.launches == before


def _bwd(kind, q, k, v, m, do, h):
    """(dq, dk, dv) of the kernel backward (K2 or K4) with the forward
    kernel's output and lse, in the packed [N, T, H*dh] layout."""
    if kind == "K2":
        out, lse = packed_attention_fwd(q, k, v, m, h, want_lse=True)
        return packed_attention_bwd(q, k, v, m, out, lse, do, h)
    q4, k4, v4, do4 = (x.unflatten(2, (h, x.shape[2] // h)) for x in (q, k, v, do))
    out, lse = segment_attention_fwd(q4, k4, v4, m, True, flash_self_attention)
    return tuple(g.flatten(2) for g in segment_attention_bwd(q4, k4, v4, m, out, lse, do4, flash_self_attention))


@pytest.mark.parametrize("kind", ["K2", "K4"])
@pytest.mark.parametrize("dh", [64, 128])
def test_attention_bwd_reads_strided_views_and_repeats_bit_for_bit(cuda, kind, dh):
    """q, k, v as column slices of one fused [N, T, 3D] projection: the
    backward reads the row-strided views in place (TMA maps over the
    caller's strides) and gives the bits it gives on contiguous copies; a
    second launch on the same inputs gives the same bits."""
    n, t, h = 3, 256, 4 if dh == 64 else 2
    d = h * dh
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn((n, t, 3 * d), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    do = torch.randn((n, t, d), generator=g, device=cuda).to(torch.bfloat16)
    m = torch.ones((n, t), device=cuda)
    m[1, 100:] = 0.0
    with torch.no_grad():
        strided = _bwd(kind, q, k, v, m, do, h)
        again = _bwd(kind, q, k, v, m, do, h)
        dense = _bwd(kind, q.contiguous(), k.contiguous(), v.contiguous(), m, do, h)
    for name, a, b, c in zip(("dq", "dk", "dv"), strided, again, dense):
        assert torch.equal(a, b), f"{name}: a repeat launch gave other bits"
        assert torch.equal(a, c), f"{name}: the strided views gave other bits than contiguous copies"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
def test_attention_bwd_di_kernel_matches_plain(cuda, dtype, dh):
    """The di kernel alone on [N, T, H, dh] views with a row stride of two
    heads' widths: rowsum(o * do) in fp32 against its plain version."""
    n, t, h = 3, 384, 3
    g = torch.Generator(device=cuda).manual_seed(12)
    fused = torch.randn((n, t, 2 * h * dh), generator=g, device=cuda).to(dtype)
    out, do = (x.unflatten(2, (h, dh)) for x in fused.split(h * dh, dim=-1))
    before = attention_bwd_di.launches
    with torch.no_grad():
        got = attention_bwd_di(out, do)
    torch.cuda.synchronize()
    assert attention_bwd_di.launches == before + 1
    assert got.shape == (n, h, t) and got.dtype == torch.float32
    atol, rtol = DI_TOL
    torch.testing.assert_close(got, attention_bwd_di_reference(out, do), rtol=rtol, atol=atol)


def test_attention_bwd_refuses_unsupported_shapes(cuda):
    """Outside their gates the backward wrappers and the di kernel raise
    instead of launching: K2 past T = 512 or at T % 128 != 0, K4 at
    T % 128 != 0 or dh 96."""
    before = (packed_attention_bwd.launches, flash_self_attention.bwd_launches, attention_bwd_di.launches)
    lse = torch.zeros((2, 2, 1024), device=cuda)
    x = torch.zeros((2, 1024, 128), device=cuda, dtype=torch.bfloat16)
    m = torch.ones((2, 1024), device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="T=1024"):
            packed_attention_bwd(x, x, x, m, x, lse, x, 2)
        y = torch.zeros((2, 320, 128), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="T=320"):
            packed_attention_bwd(y, y, y, m[:, :320], y, lse[..., :320], y, 2)
        y4 = y.unflatten(2, (2, 64))
        with pytest.raises(ValueError, match="T=320"):
            segment_attention_bwd(y4, y4, y4, m[:, :320], y4, lse[..., :320], y4, flash_self_attention)
        z4 = torch.zeros((2, 256, 2, 96), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim=96"):
            segment_attention_bwd(z4, z4, z4, m[:, :256], z4, lse[..., :256], z4, flash_self_attention)
        with pytest.raises(ValueError, match="T=320"):
            attention_bwd_di(y4, y4)
    assert (packed_attention_bwd.launches, flash_self_attention.bwd_launches, attention_bwd_di.launches) == before
