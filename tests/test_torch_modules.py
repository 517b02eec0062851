"""The PyTorch port's modules against the JAX package's on the CPU, at small
widths and float32: the same numpy inputs, the JAX variables carried over
through ``bridge.py``. Tolerance 2e-4 / 2e-5 (fp32 roundoff, as the JAX
package's own kernel tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu.models import attention as jattn
from multimodalrouting_tpu.models.behrt import BEHRTLabEncoder as JBEHRT
from multimodalrouting_tpu.models.clinbert import BertLayer as JBertLayer
from multimodalrouting_tpu.models.clinbert import BioClinBERTEncoder as JBioClinBERT
from multimodalrouting_tpu.models.cxr import ImageEncoder as JImageEncoder
from multimodalrouting_tpu.models.mult import MULTRouter as JMULTRouter
from multimodalrouting_tpu.routes import ROUTES_10
from multimodalrouting_tpu.routing import capsule_head as jhead
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.models import attention as tattn
from multimodalrouting_tpu_torch.models.behrt import BEHRTLabEncoder
from multimodalrouting_tpu_torch.models.clinbert import BertLayer, BioClinBERTEncoder
from multimodalrouting_tpu_torch.models.cxr import ImageEncoder
from multimodalrouting_tpu_torch.models.mult import MULTRouter
from multimodalrouting_tpu_torch.ops import flash_packed
from multimodalrouting_tpu_torch.routing import capsule_head as thead
from tests.torch_parity import assert_close, jitter, t

KEY = jax.random.PRNGKey(0)


def _run(jmod, tmod, *args, jax_kwargs=None, seed=0, scale=0.1):
    """Init the JAX module, jitter its variables, bridge them into the port
    module, and return (port outputs, JAX outputs) on the same inputs."""
    jax_kwargs = jax_kwargs or {}
    variables = jitter(jmod.init(KEY, *args, **jax_kwargs), seed=seed, scale=scale)
    ref = jmod.apply(variables, *args, **jax_kwargs)
    load_jax_variables(tmod, variables)
    tmod.eval()
    targs = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    with torch.no_grad():
        got = tmod(*targs)
    return got, ref


def test_sinusoidal_positions_and_future_mask():
    for dim, quantized in ((32, False), (7, True), (2, False)):
        assert_close(
            tattn.sinusoidal_positions(11, dim, quantized=quantized),
            jattn.sinusoidal_positions(11, dim, quantized=quantized),
            rtol=0, atol=0,
        )
    assert_close(tattn.future_mask(5, 7), jattn.future_mask(5, 7), rtol=0, atol=0)


@pytest.mark.parametrize("tt,frozen", [(12, False), (256, True)])
def test_multihead_attention(tt, frozen):
    """Eager MHA, and at T=256 the packed dispatch (K1's plain version on the
    CPU), against the JAX eager MHA with a key mask."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, tt, 128)).astype(np.float32)
    mask = (rng.random((2, tt)) > 0.2).astype(np.float32)
    jm = jattn.MultiheadAttention(d=128, num_heads=2, frozen_fast_path=frozen)
    tm = tattn.MultiheadAttention(128, 2, frozen_fast_path=frozen)
    calls = []
    real = flash_packed.packed_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    flash_packed.packed_attention = spy
    try:
        got, ref = _run(jm, tm, x, x, x, mask)
    finally:
        flash_packed.packed_attention = real
    assert bool(calls) == (tt == 256)
    assert_close(got, ref)


def test_attention_with_causal_bias():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 5:] = 0
    bias = np.asarray(jattn.future_mask(6, 9))
    jm = jattn.MultiheadAttention(d=32, num_heads=4)
    variables = jitter(jm.init(KEY, q, kv, kv, mask, bias), seed=2)
    ref = jm.apply(variables, q, kv, kv, mask, bias)
    tm = load_jax_variables(tattn.MultiheadAttention(32, 4), variables)
    with torch.no_grad():
        got = tm(t(q), t(kv), t(kv), t(mask), t(bias))
    assert_close(got, ref)


@pytest.mark.parametrize("pool", ["cls", "mean", "last"])
def test_behrt(pool):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 10, 16)).astype(np.float32)
    mask = np.ones((3, 10), np.float32)
    mask[1, 6:] = 0
    jm = JBEHRT(n_feats=16, d=32, seq_len=12, n_layers=2, n_heads=4, pool=pool)
    tm = BEHRTLabEncoder(16, 32, seq_len=12, n_layers=2, n_heads=4, pool=pool)
    got, ref = _run(jm, tm, x, mask)
    for g, r, name in zip(got, ref, ("seq", "mask", "pooled")):
        assert_close(g, r, err_msg=name)


@pytest.mark.parametrize("gelu,ln", [("poly", "fp32"), ("erf", "bf16")])
def test_bert_layer(gelu, ln):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 9:] = 0
    jm = JBertLayer(hidden=64, heads=4, intermediate=96, gelu=gelu, ln=ln)
    tm = BertLayer(64, 4, 96, gelu=gelu, ln=ln)
    got, ref = _run(jm, tm, x, mask)
    assert_close(got, ref)


@pytest.mark.parametrize("note_agg,chunk_agg,length", [("cls", "mean", 16), ("mean", "max", 16), ("max", "mean", 256)])
def test_bioclinbert_encoder(note_agg, chunk_agg, length):
    """Chunk-batched BERT with the proj_ln + proj projection (hidden != d),
    padded chunks and, at L=256, every layer through the packed dispatch."""
    rng = np.random.default_rng(5)
    b, s = 2, 3
    notes = {
        "input_ids": rng.integers(1, 200, size=(b, s, length)).astype(np.int32),
        "attention_mask": (rng.random((b, s, length)) > 0.2).astype(np.int32),
        "chunk_mask": np.array([[1, 1, 0], [1, 0, 0]], np.float32),
    }
    notes["attention_mask"][:, :, 0] = 1
    notes["attention_mask"] *= notes["chunk_mask"][..., None].astype(np.int32)
    kw = dict(d=32, note_agg=note_agg, chunk_agg=chunk_agg, gelu="poly", ln="fp32",
              vocab_size=200, hidden=128, layers=2, heads=2, intermediate=96, max_position=length)
    jm = JBioClinBERT(**kw)
    variables = jitter(jm.init(KEY, notes), seed=5)
    ref = jm.apply(variables, notes)
    tm = load_jax_variables(BioClinBERTEncoder(**kw), variables).eval()
    with torch.no_grad():
        got = tm({k: t(v) for k, v in notes.items()})
    for g, r, name in zip(got, ref, ("seq", "mask", "pooled")):
        assert_close(g, r, err_msg=name)
    # precomputed per-chunk embeddings skip the body
    embs = rng.normal(size=(b, s, 128)).astype(np.float32)
    ref_c = jm.apply(variables, {**notes, "chunk_embs": embs})
    with torch.no_grad():
        got_c = tm({**{k: t(v) for k, v in notes.items()}, "chunk_embs": t(embs)})
    assert_close(got_c[2], ref_c[2])


@pytest.mark.parametrize("backbone,norm", [("resnet18", "batch"), ("resnet34", "group")])
def test_image_encoder(backbone, norm):
    """ResNet with BatchNorm (nonzero running statistics) or GroupNorm(32):
    tokens, mask, pooled projection and CheXpert logits."""
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JImageEncoder(d=32, vision_backbone=backbone, norm_kind=norm)
    tm = ImageEncoder(d=32, vision_backbone=backbone, norm_kind=norm)
    # small jitter: 0.1 on every conv weight would blow activations up to 1e6
    got, ref = _run(jm, tm, x, seed=6, scale=0.01)
    for g, r, name in zip(got, ref, ("tokens", "mask", "pooled", "chexpert")):
        assert_close(g, r, err_msg=name)


@pytest.mark.parametrize("attn_mask,pool,positions", [(False, "mean", "sinusoidal"), (True, "last", "ref_quantized")])
def test_mult_router(attn_mask, pool, positions):
    """3 self + 6 cross streams over stacked [G] parameters, sequences of
    different lengths padded to one T, partial masks."""
    rng = np.random.default_rng(7)
    b, d = 3, 32
    x_l = rng.normal(size=(b, 7, d)).astype(np.float32)
    x_n = rng.normal(size=(b, 3, d)).astype(np.float32)
    x_i = rng.normal(size=(b, 4, d)).astype(np.float32)
    m_l = np.ones((b, 7), np.float32)
    m_l[0, 5:] = 0
    m_n = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], np.float32)
    m_i = np.ones((b, 4), np.float32)
    m_i[2] = 0
    kw = dict(d=d, num_heads=4, layers=2, self_layers=1, attn_mask=attn_mask, pool=pool, positions=positions)
    jm = JMULTRouter(**kw)
    tm = MULTRouter(d, d, d, **kw)
    got, ref = _run(jm, tm, x_l, x_n, x_i, m_l, m_n, m_i, seed=7)
    assert set(got) == set(ref) == set(ROUTES_10)
    for r in ROUTES_10:
        assert_close(got[r], ref[r], err_msg=r)


def test_projector_and_priors():
    rng = np.random.default_rng(8)
    embs = {r: rng.normal(size=(4, 16)).astype(np.float32) for r in ROUTES_10}
    jm = jhead.RoutePrimaryProjector(routes=ROUTES_10, d_in=16, pc_dim=6, use_route_logit_bias=True, prior_floor=0.05)
    tm = thead.RoutePrimaryProjector(ROUTES_10, 16, 6, use_route_logit_bias=True, prior_floor=0.05)
    variables = jitter(jm.init(KEY, embs), seed=8)
    ref_p, ref_a = jm.apply(variables, embs)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got_p, got_a = tm({k: t(v) for k, v in embs.items()})
    assert_close(got_p, ref_p)
    assert_close(got_a, ref_a)
    mask = (rng.random((4, 10)) > 0.3).astype(np.float32)
    for kw in (dict(act_temperature=1.0), dict(act_temperature=2.0, prior_floor=0.1, prior_ceiling=0.9)):
        assert_close(
            thead.compose_priors(got_a, route_mask=t(mask), **kw),
            jhead.compose_priors(ref_a, route_mask=jnp.asarray(mask), **kw),
            err_msg=str(kw),
        )


@pytest.mark.parametrize(
    "head_style,routing_mode",
    [("rmatrix", "softmax_out"), ("class_linear", "softmax_out"), ("class_embed", "sigmoid_routes")],
)
def test_capsule_head(head_style, routing_mode):
    rng = np.random.default_rng(9)
    b, r, pc = 4, 10, 8
    poses = rng.normal(size=(b, r, pc)).astype(np.float32)
    priors = rng.uniform(0.05, 0.95, size=(b, r, 1)).astype(np.float32)
    mask = (rng.random((b, r)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    kw = dict(num_routes=r, pc_dim=pc, mc_caps_dim=16, num_classes=3, head_style=head_style, routing_mode=routing_mode)
    jm = jhead.CapsuleHead(**kw)
    tm = thead.CapsuleHead(**kw)
    got, ref = _run(jm, tm, poses, priors, mask, seed=9)
    for g, rr, name in zip(got, ref, ("logits", "alpha", "r_matrix", "coef")):
        assert_close(g, rr, err_msg=name)
