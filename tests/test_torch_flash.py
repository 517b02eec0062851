"""The port's segment attention (K4a flash, K4b splash; ops/flash.py) and
its attention dispatch (models/attention.py) against the JAX package on the
CPU.

The plain versions of K4's forward and backward are held against the JAX
package's ``flash_self_attention`` with the upstream Pallas kernel in TPU
interpret mode and ``splash_self_attention`` with MMR_SPLASH_INTERPRET=1, on
every row (pad queries and an all-pad chunk included), with gradients. The
dispatch test runs the JAX MultiheadAttention with its kernel entry points
replaced by recording stand-ins (the TPU kernels do not run on a CPU) and
holds the port's choice of branch, and its output on valid rows, against it
for each MMR_ATTN value and each class of shape. The kernels themselves are
held against these plain versions on the card in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from multimodalrouting_tpu.models import attention as jattention
from multimodalrouting_tpu.ops import flash as jflash
from multimodalrouting_tpu.ops import flash_packed as jflash_packed
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.models import attention as tattention
from multimodalrouting_tpu_torch.ops import flash as tflash
from multimodalrouting_tpu_torch.ops import flash_packed as tflash_packed
from tests.torch_parity import assert_close, t


def _inputs(b, tt, h, dh, seed):
    """q (scaled), k, v [B, T, H, dh], a cotangent, and a mask with a ragged
    pad tail in chunk 0 and, with two or more chunks, an all-pad last chunk."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, tt, h, dh)) * dh**-0.5).astype(np.float32)
    k, v, do = (rng.normal(size=(b, tt, h, dh)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, tt), np.float32)
    valid[0, tt // 2 + 3 :] = 0.0
    if b > 1:
        valid[-1] = 0.0
    return q, k, v, do, valid


def _jax_value_and_grads(fn, q, k, v, do, valid):
    m = jnp.asarray(valid)
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), m)
    grads = jax.grad(lambda a, b_, c: (fn(a, b_, c, m) * jnp.asarray(do)).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return out, grads


def _port_value_and_grads(wrapper, q, k, v, do, valid):
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = wrapper(tq, tk, tv, t(valid))
    return out, torch.autograd.grad(out, (tq, tk, tv), t(do))


def _assert_every_row(got, ref):
    out, grads = got
    ref_out, ref_grads = ref
    assert torch.isfinite(out).all()
    assert_close(out, ref_out, err_msg="out")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert_close(g, r, err_msg=name)


@pytest.mark.parametrize("b,tt,h,dh", [(2, 256, 3, 64), (1, 512, 2, 128), (1, 1024, 1, 64)])
def test_segment_attention_plain_matches_flash_kernel(b, tt, h, dh):
    """K4a: the plain forward and its gradient == the upstream flash kernel
    in TPU interpret mode, every row; T = 1024 runs two 512-key blocks."""
    q, k, v, do, valid = _inputs(b, tt, h, dh, seed=tt + h)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_value_and_grads(jflash.flash_self_attention, q, k, v, do, valid)
    before = (tflash.flash_self_attention.launches, tflash.flash_self_attention.bwd_launches)
    _assert_every_row(_port_value_and_grads(tflash.flash_self_attention, q, k, v, do, valid), ref)
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert (tflash.flash_self_attention.launches, tflash.flash_self_attention.bwd_launches) == before


@pytest.mark.parametrize("b,tt,h,dh", [(2, 256, 3, 64), (1, 512, 2, 128)])
def test_segment_attention_plain_matches_splash_kernel(monkeypatch, b, tt, h, dh):
    """K4b: the same plain versions == the upstream splash kernel (all
    FullMask) in interpret mode, every row."""
    monkeypatch.setenv("MMR_SPLASH_INTERPRET", "1")
    q, k, v, do, valid = _inputs(b, tt, h, dh, seed=tt + 2 * h)
    ref = _jax_value_and_grads(jflash.splash_self_attention, q, k, v, do, valid)
    _assert_every_row(_port_value_and_grads(tflash.splash_self_attention, q, k, v, do, valid), ref)


def test_segment_semantics_on_pad_rows():
    """Pad queries attend the pad keys only and an all-pad chunk gets an
    ordinary softmax: not K1's function on those rows, K1's on valid rows."""
    q, k, v, _, valid = _inputs(2, 256, 2, 64, seed=1)
    got = tflash.segment_attention_reference(t(q), t(k), t(v), t(valid))
    k1 = tflash_packed.packed_attention_reference(*(t(x).reshape(2, 256, 128) for x in (q, k, v)), t(valid), 2)
    k1 = k1.reshape(2, 256, 2, 64)
    rows = torch.from_numpy(valid).bool()
    torch.testing.assert_close(got[rows], k1[rows], rtol=2e-5, atol=2e-6)
    assert (got[~rows] - k1[~rows]).abs().max() > 0.1
    # the all-pad chunk against a plain softmax over all of its keys
    s = torch.einsum("qhd,khd->hqk", t(q[1]), t(k[1]))
    plain = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), t(v[1]))
    torch.testing.assert_close(got[1], plain, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("env", [{}, {"MMR_ATTN": "splash"}, {"MMR_ATTN": "packed"}, {"MMR_ATTN": "xla"},
                                 {"MMR_FLASH": "0", "MMR_ATTN": "splash"}, {"MMR_FLASH": "1", "MMR_ATTN": "flash"}])
def test_attention_impl_and_gate_match_jax(monkeypatch, env):
    monkeypatch.delenv("MMR_ATTN", raising=False)
    monkeypatch.delenv("MMR_FLASH", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert tflash.attention_impl() == jflash.attention_impl()
    for args in [(256, 256, 64), (512, 512, 128), (128, 128, 64), (384, 384, 64), (1152, 1152, 64),
                 (320, 320, 64), (256, 256, 32), (256, 512, 64)]:
        assert tflash.supports(*args) == jflash.supports(*args), args


# (T, heads, head_dim): every class of shape the dispatch tells apart
SHAPES = {
    "packed gate holds": (256, 2, 64),
    "odd 64-wide heads (hidden 192)": (256, 3, 64),
    "512 < T <= 1024": (640, 2, 64),
    "T > 1024": (1152, 1, 64),
    "T < 256": (128, 2, 64),
}


def _jax_segment(q, k, v, kv_mask):
    """Upstream's plain segment attention over [B, T, H, dh] (what the TPU
    flash and splash kernels compute)."""
    ids = kv_mask.astype(jnp.int32)
    tr = lambda x: jnp.transpose(x, (0, 2, 1, 3))  # noqa: E731
    return tr(mha_reference(tr(q), tr(k), tr(v), None, segment_ids=SegmentIds(ids, ids)))


@pytest.mark.parametrize("impl", ["flash", "packed", "splash", "xla"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_attention_dispatch_matches_jax(monkeypatch, impl, shape):
    """Which branch a self-attention call takes, frozen or not, and its
    output on valid rows, against the JAX package's dispatch
    (attention.py:163-206) with flash_available() forced on."""
    tt, h, dh = SHAPES[shape]
    d = h * dh
    monkeypatch.delenv("MMR_FLASH", raising=False)
    monkeypatch.setenv("MMR_ATTN", impl)
    taken = {}

    def spy(side, branch, fn):
        def call(*args, **kwargs):
            taken[side] = branch
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(jflash, "flash_available", lambda: True)
    monkeypatch.setattr(jflash_packed, "packed_flash_self_attention",
                        spy("jax", "packed", lambda q, k, v, m, h_: jflash_packed._xla_attention(q, k, v, m, h_)))
    monkeypatch.setattr(jflash, "flash_self_attention", spy("jax", "flash", _jax_segment))
    monkeypatch.setattr(jflash, "splash_self_attention", spy("jax", "splash", _jax_segment))
    monkeypatch.setattr(tflash_packed, "packed_attention", spy("port", "packed", tflash_packed.packed_attention))
    monkeypatch.setattr(tflash, "flash_self_attention", spy("port", "flash", tflash.flash_self_attention))
    monkeypatch.setattr(tflash, "splash_self_attention", spy("port", "splash", tflash.splash_self_attention))

    rng = np.random.default_rng(tt + h)
    x = rng.normal(size=(2, tt, d)).astype(np.float32)
    valid = np.ones((2, tt), np.float32)
    valid[0, tt // 3 :] = 0.0
    for frozen in (True, False):
        taken.clear()
        jmod = jattention.MultiheadAttention(d=d, num_heads=h, frozen_fast_path=frozen)
        xj = jnp.asarray(x)
        params = jmod.init(jax.random.PRNGKey(0), xj, xj, xj, jnp.asarray(valid))
        ref = jmod.apply(params, xj, xj, xj, jnp.asarray(valid))
        tmod = load_jax_variables(tattention.MultiheadAttention(d, h, frozen_fast_path=frozen), params)
        with torch.no_grad():
            got = tmod(t(x), t(x), t(x), kv_mask=t(valid))
        branch = taken.get("port", "eager")
        assert branch == taken.get("jax", "eager"), (frozen, taken)
        assert branch == tattention.attention_branch(tt, tt, dh, d, h, frozen_fast_path=frozen, needs_grad=False)
        rows = valid.astype(bool)
        assert_close(got[torch.from_numpy(rows)], np.asarray(ref)[rows], err_msg=f"frozen={frozen} {branch}")


def test_packed_forced_beyond_its_backward_takes_eager_autograd(monkeypatch):
    """MMR_ATTN=packed under a gradient at 512 < T <= 1024: the JAX package
    runs K1 forward and the XLA attention's VJP; the port takes autograd of
    its eager attention (the same function). Under the default selector a
    fine-tuned layer there takes K4a."""
    monkeypatch.setenv("MMR_ATTN", "packed")
    assert tattention.attention_branch(640, 640, 64, 128, 2, frozen_fast_path=True, needs_grad=True) == "eager"
    assert tattention.attention_branch(640, 640, 64, 128, 2, frozen_fast_path=True, needs_grad=False) == "packed"
    rng = np.random.default_rng(5)
    q, k, v = (t(rng.normal(size=(2, 640, 128)).astype(np.float32)).requires_grad_() for _ in range(3))
    valid = torch.ones((2, 640))
    valid[1, 300:] = 0.0
    out = tattention.attention(q, k, v, valid, None, 2, frozen_fast_path=True, dtype=torch.float32)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(torch.isfinite(g).all() for g in grads)
    monkeypatch.setenv("MMR_ATTN", "flash")
    assert tattention.attention_branch(640, 640, 64, 128, 2, frozen_fast_path=False, needs_grad=True) == "flash"


def test_segment_attention_refuses_shapes_outside_the_gate():
    x = torch.zeros((1, 192, 2, 64))
    with pytest.raises(ValueError, match="T=192"):
        tflash.flash_self_attention(x, x, x, None)
    x = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError, match="head_dim=32"):
        tflash.splash_self_attention(x, x, x, None)
