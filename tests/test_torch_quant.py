"""The port's int8 frozen-BERT body (``ops/quant.py``, ``encoder.int8_text``)
against the JAX package's on the CPU: the quantizers bit for bit (int8
values and scales, half-to-even rounding, the +-127 clip), the int32
product, ``QuantDense`` and the int8 ``BertEncoder`` against JAX's int8
modules on the same weights and against fp32 at JAX's own bounds
(tests/test_quant.py), the refusals, and the flagship with the int8 body."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodalrouting_tpu.models.clinbert import BertEncoder as JBertEncoder
from multimodalrouting_tpu.ops import quant as jquant
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.data.batches import batch_to
from multimodalrouting_tpu_torch.models.clinbert import BertEncoder, BioClinBERTEncoder
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.ops import quant
from multimodalrouting_tpu_torch.train.text_cache import compute_note_chunk_embs
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import compiled, one_torch_thread, seeded_like  # noqa: F401 (one_torch_thread: a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
KEY = jax.random.PRNGKey(0)
# QuantDense against JAX's on the same weights and input: the int8 values
# and the int32 products are equal, and the fp32 dequantization and bias add
# run in the same order
QUANT_DENSE_TOL = (1e-6, 1e-6)  # (rtol, atol)
# The int8 BERT against JAX's: upstream of each quantization LayerNorm,
# GELU and softmax sum in another order (the fp32 bodies agree to ~3e-7), so
# an activation whose x / s lies within fp32 rounding of a half step rounds
# to the other int8 neighbour, and that token's later states move by about
# one quantization step (most tokens stay bit-identical). The bound: the
# relative Frobenius distance to JAX's int8 output is under a fifth of JAX's
# own int8 error against fp32 (measured: 1.5e-3 against 1.35e-2)
INT8_BERT_REL = 0.2
BERT = dict(vocab_size=500, hidden=64, layers=2, heads=4, intermediate=128, max_position=64)


def _halves(rng):
    """Values whose quotient by the row scale is an exact half (the row max is
    127, so the scale is 1): rounding must go to the even neighbour."""
    x = rng.standard_normal((6, 32)).astype(np.float32) * 3.0
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    return x


def test_quantize_per_channel_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((32, 48)) * 3.0).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero channel: the 1e-8 scale floor
    jq, js = (np.asarray(a) for a in jquant.quantize_per_channel(jnp.asarray(w)))
    for got_w, axis, back in ((torch.from_numpy(w), 0, lambda a: a), (torch.from_numpy(w.T.copy()), 1, lambda a: a.T)):
        tq, ts = quant.quantize_per_channel(got_w, axis=axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(back(tq.numpy()), jq)
        np.testing.assert_array_equal(back(ts.numpy()), js)
    assert int(np.abs(jq.astype(np.int32)).max()) <= 127


def test_quantize_per_token_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    for x in (rng.standard_normal((4, 7, 32)).astype(np.float32) * 5.0, _halves(rng)):
        jq, js = (np.asarray(a) for a in jquant.quantize_per_token(jnp.asarray(x)))
        tq, ts = quant.quantize_per_token(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(ts.numpy(), js)
    assert tq[0, :6].tolist() == [127, 2, -4, 0, 0, 2]  # half to even


def test_int8_matmul_matches_jax_exactly():
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=(2, 5, 64)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(64, 24)).astype(np.int8)
    got = quant.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.int8_matmul(jnp.asarray(xq), jnp.asarray(wq))))


def _dense_pair(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    params = {"params": {"kernel": (rng.standard_normal((96, 80)) / np.sqrt(96)).astype(np.float32),
                         "bias": (0.1 * rng.standard_normal(80)).astype(np.float32)}}
    dense = quant.QuantDense(96, 80)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(params["params"]["kernel"].T.copy()))
        dense.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    return x, params, dense


def test_quant_dense_matches_jax_quant_dense_and_fp32():
    """Against JAX's QuantDense on the same parameters (QUANT_DENSE_TOL), and
    against the fp32 Dense at the JAX test's bounds (relative Frobenius
    error < 0.05, worst element < 0.2 of the output's std)."""
    x, params, dense = _dense_pair(4)
    ref_q = np.asarray(jquant.QuantDense(80).apply(params, jnp.asarray(x)))
    ref = np.asarray(nn.Dense(80).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = dense(torch.from_numpy(x)).numpy()
    rtol, atol = QUANT_DENSE_TOL
    np.testing.assert_allclose(got, ref_q, rtol=rtol, atol=atol)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.05
    assert float(np.abs(got - ref).max()) < 0.2 * float(ref.std())
    assert sorted(dense.state_dict()) == ["bias", "weight"]


@pytest.fixture(scope="module")
def bert_pair():
    """JAX int8 and fp32 BertEncoders on seeded weights, and the port's int8
    and fp32 ones holding them; ids and mask [4, 64]."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 500, size=(4, 64)).astype(np.int32)
    attn = np.ones((4, 64), np.float32)
    attn[1, 40:] = 0.0
    variables = {"params": seeded_like(jax.eval_shape(JBertEncoder(**BERT).init, KEY, ids, attn)["params"], 6)}
    refs = {int8: np.asarray(compiled(lambda v, i, a, q=int8: JBertEncoder(int8=q, **BERT).apply(v, i, a),
                                      variables, ids, attn))
            for int8 in (False, True)}
    ports = {int8: load_jax_variables(BertEncoder(**BERT, int8=int8), variables).eval() for int8 in (False, True)}
    return ids, attn, refs, ports


def test_int8_bert_matches_jax_int8_bert(bert_pair):
    ids, attn, refs, ports = bert_pair
    with torch.no_grad():
        got = ports[True](torch.from_numpy(ids), torch.from_numpy(attn)).numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, refs[True]) < INT8_BERT_REL * rel(refs[True], refs[False])
    assert isinstance(ports[True].layer_0.intermediate, quant.QuantDense)
    assert isinstance(ports[True].layer_1.attention.attn.q_proj, quant.QuantDense)


def test_int8_bert_close_to_fp32_bert(bert_pair):
    """The JAX test's bound: the CLS states' cosine against the fp32 body
    stays above 0.995, in the port and in the JAX package alike."""
    ids, attn, refs, ports = bert_pair
    with torch.no_grad():
        got = ports[True](torch.from_numpy(ids), torch.from_numpy(attn)).numpy()[:, 0]
        fp = ports[False](torch.from_numpy(ids), torch.from_numpy(attn)).numpy()[:, 0]
    np.testing.assert_allclose(fp, refs[False][:, 0], rtol=2e-4, atol=2e-5)

    def cos(a, b):
        return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-9)

    assert float(cos(got, fp).min()) > 0.995
    assert float(cos(refs[True][:, 0], refs[False][:, 0]).min()) > 0.995


@pytest.mark.parametrize("kwargs, match", [
    ({"finetune_text": True}, "int8 frozen-BERT path requires finetune_text=False"),
    ({"pipeline": True}, "pipeline BERT does not compose with int8"),
])
def test_int8_refusals_carry_the_jax_messages(kwargs, match):
    with pytest.raises(ValueError, match=match):
        BioClinBERTEncoder(d=16, int8=True, vocab_size=100, hidden=32, layers=1, heads=2, intermediate=64,
                           max_position=32, **kwargs)


def test_flagship_with_the_int8_body_keeps_fp32_masters_and_serves():
    """encoder.int8_text=true under bf16 compute: the BERT body stays fp32
    (no bf16 cast at rest, as the JAX state skips it under int8) and takes no
    gradient; the forward is finite, close to the fp32 body's; the text
    cache takes the int8 body too."""
    # the fp32 LayerNorm: the text cache's encoder takes no `ln=` (JAX's)
    over = {**TINY, "model.dtype": "bfloat16", "encoder.int8_text": True, "encoder.bert_ln": "fp32"}
    cfg = tc.apply_overrides(tc.Config(), over)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    bert = model.encoders.bbert.bert
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in bert.parameters())
    assert isinstance(bert.layer_0.output, quant.QuantDense)
    batch = tiny_batch(n=3, seed=2)
    torch.manual_seed(0)
    plain = build_model(tc.apply_overrides(tc.Config(), {**over, "encoder.int8_text": False}), device="cpu")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        out, ref = model(batch_to(batch, "cpu")), plain(batch_to(batch, "cpu"))
    assert torch.isfinite(out.logits).all() and torch.isfinite(out.alpha).all()
    assert float(out.pooled["N"].float().abs().max()) > 0
    cos = torch.nn.functional.cosine_similarity(out.pooled["N"].float(), ref.pooled["N"].float(), dim=-1)
    assert float(cos.min()) > 0.99
    embs = compute_note_chunk_embs(cfg, model, batch)
    with torch.no_grad():
        direct = model.encoders.bbert.chunk_embeddings(
            torch.from_numpy(batch.note_ids.reshape(-1, batch.note_ids.shape[-1])),
            torch.from_numpy(batch.note_attn.reshape(-1, batch.note_attn.shape[-1])))
    torch.testing.assert_close(embs.reshape(direct.shape).float(), direct.float(), rtol=0, atol=0)
