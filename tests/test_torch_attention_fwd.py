"""The attention forward's plain version in the Hopper kernel's own order
(``ops/flash.py:attention_fwd_tiled_reference``: an online softmax over key
tiles, p rounded to the input type unnormalised against the running maximum)
on the CPU: in fp32 against the TPU packed kernel (K1) in interpret mode, the
upstream flash kernel (K4a) in TPU interpret mode and the port's plain
versions in the TPU order, every row, with a ragged pad tail, an all-pad
chunk and a chunk whose first key tile is all padding; its lse against the
log-sum-exp of the masked logits; in bf16 within the TPU order's limits and
apart from a planted fault. The kernel itself is held against this version
on the card in tests/test_torch_kernels.py and chip_smoke.py."""
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import (
    bf16_errors,
    describe_tiled,
    tiled_without_correction,
    within_bf16_limits,
    within_tiled_limits,
)
from multimodalrouting_tpu.ops import flash as jflash
from multimodalrouting_tpu.ops.flash_packed import packed_flash_self_attention
from multimodalrouting_tpu_torch.ops import hopper
from multimodalrouting_tpu_torch.ops.flash import (
    attention_fwd_tiled_reference,
    fwd_block_k,
    segment_attention_reference,
)
from multimodalrouting_tpu_torch.ops.flash_packed import packed_attention_reference
from tests.torch_parity import assert_close, t

RTOL, ATOL = 2e-4, 2e-5  # fp32, as tests/test_pallas.py holds the packed kernels
SHAPES = [(256, 64), (512, 64), (1024, 64), (256, 128), (512, 128), (1024, 128)]


def _heads(dh: int) -> int:
    return 2 if dh == 64 else 1  # the packed gate wants an even head count at dh 64


@functools.lru_cache(maxsize=None)
def _inputs(tt: int, dh: int):
    """q (scaled), k, v [3, T, H, dh] fp32 and the mask: chunk 0 has a ragged
    pad tail, chunk 1 is all padding, chunk 2's first 128 keys are padding
    (a key tile fully masked for every row under the key mask, and for the
    valid rows under segment ids)."""
    rng = np.random.default_rng(tt + dh)
    h = _heads(dh)
    q = (rng.normal(size=(3, tt, h, dh)) * dh**-0.5).astype(np.float32)
    k, v = (rng.normal(size=(3, tt, h, dh)).astype(np.float32) for _ in range(2))
    valid = np.ones((3, tt), np.float32)
    valid[0, 190:] = 0.0
    valid[1] = 0.0
    valid[2, :128] = 0.0
    return q, k, v, valid


@functools.lru_cache(maxsize=None)
def _jax_packed(tt: int, dh: int) -> np.ndarray:
    q, k, v, valid = _inputs(tt, dh)
    h = _heads(dh)
    flat = [jnp.asarray(x.reshape(3, tt, h * dh)) for x in (q, k, v)]
    out = packed_flash_self_attention(*flat, jnp.asarray(valid), h, interpret=True)
    return np.asarray(out).reshape(3, tt, h, dh)


@functools.lru_cache(maxsize=None)
def _jax_flash(tt: int, dh: int) -> np.ndarray:
    q, k, v, valid = _inputs(tt, dh)
    with pltpu.force_tpu_interpret_mode():
        out = jflash.flash_self_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid))
    return np.asarray(out)


def _tiled(tt: int, dh: int, mode: str, block_k: int):
    q, k, v, valid = _inputs(tt, dh)
    return attention_fwd_tiled_reference(t(q), t(k), t(v), t(valid), mode, block_k)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("tt,dh", SHAPES)
def test_tiled_matches_tpu_packed_kernel(tt, dh, block_k):
    """Key mask: the tiled version == K1's TPU kernel in interpret mode, on
    every row (the all-pad chunk's uniform rows included)."""
    out, lse = _tiled(tt, dh, "key_mask", block_k)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert_close(out, _jax_packed(tt, dh), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("tt,dh", SHAPES)
def test_tiled_matches_upstream_flash_kernel(tt, dh, block_k):
    """Segment ids: the tiled version == the upstream flash kernel (K4a) in
    TPU interpret mode, every row (pad queries attend the pad keys)."""
    out, lse = _tiled(tt, dh, "segment", block_k)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert_close(out, _jax_flash(tt, dh), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("mode", ["key_mask", "segment"])
@pytest.mark.parametrize("tt,dh", [(256, 64), (1024, 128)])
def test_tiled_matches_plain_versions(tt, dh, mode, block_k):
    """In fp32 the tiled order and the wrappers' plain versions (the TPU
    order) compute one function: every row at 2e-5."""
    q, k, v, valid = (t(x) for x in _inputs(tt, dh))
    h = _heads(dh)
    if mode == "key_mask":
        ref = packed_attention_reference(*(x.flatten(2) for x in (q, k, v)), valid, h).unflatten(2, (h, dh))
    else:
        ref = segment_attention_reference(q, k, v, valid)
    out, _ = attention_fwd_tiled_reference(q, k, v, valid, mode, block_k)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("mode", ["key_mask", "segment"])
def test_tiled_lse_is_the_logsumexp_of_the_masked_logits(mode, block_k):
    """lse = m + log l equals logsumexp of the masked logits on every valid
    row (every row under segment ids); under the key mask an all-pad row's
    lse is at most -1e29 (it rounds to -1e30: the backward's test for such
    rows)."""
    q, k, v, valid = (t(x) for x in _inputs(512, 64))
    _, lse = attention_fwd_tiled_reference(q, k, v, valid, mode, block_k)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mode == "key_mask":
        s = s + ((1.0 - valid) * -1e30)[:, None, None, :]
    else:
        s = s + torch.where(valid[:, None, :, None] == valid[:, None, None, :], 0.0, -0.7 * np.finfo(np.float32).max)
    want = torch.logsumexp(s, dim=-1)  # [N, H, T]
    assert lse.shape == want.shape and lse.dtype == torch.float32
    rows = torch.ones_like(want, dtype=torch.bool)
    if mode == "key_mask":
        all_pad = valid.sum(dim=1) == 0
        rows[all_pad] = False
        assert bool((lse[all_pad] <= -1e29).all())
    torch.testing.assert_close(lse[rows], want[rows], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mode", ["key_mask", "segment"])
def test_tiled_bf16_within_the_tpu_order_limits(mode):
    """bf16: the tiled order sits within the TPU order's limits of the plain
    version (p rounded once, at another place), and outside the tight limits
    that hold the kernel to it; a correction factor left out is outside both."""
    q, k, v, valid = (t(x) for x in _inputs(512, 64))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    h = _heads(64)
    if mode == "key_mask":
        plain = lambda a, b, c: packed_attention_reference(  # noqa: E731
            *(x.flatten(2) for x in (a, b, c)), valid, h).unflatten(2, (h, 64))
    else:
        plain = lambda a, b, c: segment_attention_reference(a, b, c, valid)  # noqa: E731
    ref, exact = plain(qb, kb, vb), plain(qb.float(), kb.float(), vb.float())
    tiled, _ = attention_fwd_tiled_reference(qb, kb, vb, valid, mode, 128)
    assert tiled.dtype == torch.bfloat16
    assert within_bf16_limits(bf16_errors(tiled, ref, exact))
    tiled_exact, _ = attention_fwd_tiled_reference(qb.float(), kb.float(), vb.float(), valid, mode, 128)
    e = bf16_errors(ref, tiled, tiled_exact)
    assert not within_tiled_limits(e), describe_tiled(e)
    assert within_tiled_limits(bf16_errors(tiled, tiled, tiled_exact))
    bad = tiled_without_correction(qb, kb, vb, valid, mode, 128)
    assert not within_bf16_limits(bf16_errors(bad, ref, exact))
    assert not within_tiled_limits(bf16_errors(bad, tiled, tiled_exact))


def test_tiled_reference_refuses_an_unknown_mode():
    q, k, v, valid = (t(x) for x in _inputs(256, 64))
    with pytest.raises(ValueError, match="key_mask or segment"):
        attention_fwd_tiled_reference(q, k, v, valid, "causal", 128)


def test_block_k_matches_the_kernel_source():
    """The tiled version's default tile (fwd_block_k) is the kernel's."""
    with open(os.path.join(hopper.CSRC_DIR, "attention_fwd.cuh")) as f:
        src = f.read()
    body = re.search(r"constexpr int fwd_block_k\(\) \{\s*return DH == 64 \? (\d+) : (\d+);", src)
    assert body is not None
    assert (fwd_block_k(64), fwd_block_k(128)) == (int(body.group(1)), int(body.group(2)))
