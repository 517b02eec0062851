"""The port's frozen-BERT note-embedding cache (train/text_cache.py) against
the JAX package's on the CPU, fp32, at tiny widths with a projection
(BERT hidden 48 -> d 32):

- the cache equals JAX ``compute_note_chunk_embs`` on the same weights
  under ``encoder.bert_ln=fp32`` and under the default ``bf16`` (both caches
  run the fp32 LayerNorm whatever the setting says), and holds the at-rest
  dtype's rounding (bf16 BERT weights under bf16 compute);
- a minibatched cache equals a single-shot one;
- cached and uncached forwards agree (2e-4 / 2e-5) where the LayerNorms
  agree (``bert_ln=fp32``), and ``train_model`` trains the same from the
  cache as without it;
- the refusals: a fine-tuned BERT body, a streaming split;
- ``cli train`` and ``cli eval --drop-table`` with the cache run the BERT
  body only in the cache pass.
"""
import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalrouting_tpu import configs as jc
from multimodalrouting_tpu.models.full import build_model as jbuild_model
from multimodalrouting_tpu.train import text_cache as jtext_cache
from multimodalrouting_tpu_torch import cli as tcli
from multimodalrouting_tpu_torch import configs as tc
from multimodalrouting_tpu_torch.bridge import load_jax_variables
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to
from multimodalrouting_tpu_torch.models.clinbert import BertEncoder
from multimodalrouting_tpu_torch.models.full import build_model
from multimodalrouting_tpu_torch.train import text_cache
from multimodalrouting_tpu_torch.train.loop import train_model
from tests.helpers import TINY, tiny_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_close,
    one_torch_thread,
    relative_errors,
    seeded_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CACHE = {**TINY, "encoder.bert_hidden": 48, "encoder.bert_intermediate": 64, "encoder.text_max_len": 16,
         "encoder.image_size": 32, "model.attn_dropout": 0.0, "model.relu_dropout": 0.0, "model.res_dropout": 0.0,
         "model.embed_dropout": 0.0}


def cfgs(**extra):
    over = {**CACHE, **extra}
    return jc.apply_overrides(jc.Config(), over), tc.apply_overrides(tc.Config(), over)


def _case(**extra):
    """(JAX cfg, port cfg, JAX variables as numpy, the port model with them,
    a 6-stay cohort)."""
    jcfg, tcfg = cfgs(**extra)
    cohort = tiny_batch(n=6, seed=4, missing_rate=0.3)
    variables = seeded_variables(jbuild_model(jcfg, "capsule"), jax.tree_util.tree_map(jnp.asarray, cohort), 5)
    return jcfg, tcfg, variables, load_jax_variables(build_model(tcfg, device="cpu"), variables), cohort


def _jax_cache(jcfg, variables, cohort, batch_size=0):
    """JAX compute_note_chunk_embs (its per-minibatch program is jitted)."""
    return jtext_cache.compute_note_chunk_embs(jcfg, variables["params"], cohort, batch_size=batch_size)


@pytest.mark.parametrize("ln", ["fp32", "bf16"])
def test_cache_matches_jax(ln):
    jcfg, tcfg, variables, model, cohort = _case(**{"encoder.bert_ln": ln})
    ref = _jax_cache(jcfg, variables, cohort, batch_size=4)
    got = text_cache.compute_note_chunk_embs(tcfg, model, cohort, batch_size=4)
    assert tuple(got.shape) == (6, 2, 48) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert_close(got, ref)


def test_cache_holds_the_at_rest_dtype():
    """bf16 compute with the frozen body in bf16: the cache is the bf16
    body's embedding, in bf16, within bf16 rounding of JAX's."""
    extra = {"model.dtype": "bfloat16", "encoder.bert_ln": "fp32"}
    jcfg, tcfg, variables, model, cohort = _case(**extra)
    assert next(model.encoders.bbert.bert.parameters()).dtype == torch.bfloat16
    got = text_cache.compute_note_chunk_embs(tcfg, model, cohort)
    ref = np.asarray(_jax_cache(jcfg, variables, cohort), np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2.0**-6 * np.abs(ref).max(), err
    # under the default bf16 LayerNorm the cache keeps its fp32 one, as the
    # JAX package's does: it is not the model's own per-chunk embedding
    own_cfg = tc.apply_overrides(tcfg, {"encoder.bert_ln": "bf16"})
    own = load_jax_variables(build_model(own_cfg, device="cpu"), variables)
    assert torch.equal(text_cache.compute_note_chunk_embs(own_cfg, own, cohort), got)
    ids, attn = torch.as_tensor(cohort.note_ids).reshape(12, -1), torch.as_tensor(cohort.note_attn).reshape(12, -1)
    with torch.no_grad():
        assert not torch.equal(own.encoders.bbert.chunk_embeddings(ids, attn).reshape(6, 2, -1), got)


def test_minibatched_cache_equals_single_shot():
    _, tcfg, _, model, cohort = _case()
    whole = text_cache.compute_note_chunk_embs(tcfg, model, cohort, batch_size=6)
    for bs in (1, 4):
        assert_close(text_cache.compute_note_chunk_embs(tcfg, model, cohort, batch_size=bs), whole,
                     rtol=1e-6, atol=1e-7)


def test_cached_forward_equals_uncached():
    _, tcfg, _, model, cohort = _case(**{"encoder.bert_ln": "fp32"})
    cached = text_cache.attach_note_cache(tcfg, model, cohort)
    assert isinstance(cached.note_chunk_embs, torch.Tensor) and cohort.note_chunk_embs is None
    with torch.no_grad():
        ref = model(batch_to(Batch(*cohort), "cpu"))
        got = model(batch_to(cached, "cpu"))
    for name in ("logits", "alpha", "r_matrix"):
        assert_close(getattr(got, name), getattr(ref, name), err_msg=name)


def _train(tcfg, cache: bool, logs):
    tcfg = tc.apply_overrides(tcfg, {"encoder.text_embedding_cache": cache, "train.epochs": 1,
                                     "train.min_epochs": 0, "train.sampler_mode": "none"})
    torch.manual_seed(0)
    model = build_model(tcfg, device="cpu", train=True)
    result = train_model(tcfg, model, tiny_batch(n=12, seed=6), tiny_batch(n=8, seed=7), log_fn=logs.append)
    return model, result


def test_train_model_trains_the_same_from_the_cache():
    """Three steps and the validation passes, cached against uncached, with
    the cache's LayerNorm (bert_ln=fp32)."""
    _, tcfg = cfgs(**{"encoder.bert_ln": "fp32"})
    logs = []
    ref_model, ref = _train(tcfg, False, logs)
    model, got = _train(tcfg, True, logs)
    assert sum(line.startswith("[text-cache] frozen-BERT chunk embeddings precomputed for 12+8 stays") for line in logs) == 1
    np.testing.assert_allclose(got.history[0]["train_loss"], ref.history[0]["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got.history[0]["val_auroc"], ref.history[0]["val_auroc"], rtol=1e-5)
    errors = relative_errors(model.state_dict(), ref_model.state_dict())
    worst = max(errors, key=errors.get)
    assert errors[worst] <= 1e-5, (worst, errors[worst])
    assert got.state.step == 3


def test_refusals():
    _, tcfg = cfgs(**{"encoder.text_embedding_cache": True, "encoder.finetune_text": True})
    model = build_model(tcfg, device="cpu", train=True)
    with pytest.raises(ValueError, match="requires finetune_text=False"):
        text_cache.attach_note_cache(tcfg, model, tiny_batch(n=2))
    with pytest.raises(ValueError, match="requires finetune_text=False"):
        train_model(tcfg, model, tiny_batch(n=4), tiny_batch(n=4), log_fn=lambda s: None)

    class Streaming:
        def epoch_iter(self):
            return iter(())

    _, tcfg = cfgs(**{"encoder.text_embedding_cache": True})
    with pytest.raises(ValueError, match="needs a dense split; unset data.stream"):
        train_model(tcfg, build_model(tcfg, device="cpu", train=True), Streaming(), tiny_batch(n=4))


TINY_CLI = {k: v for k, v in CACHE.items() if k not in ("train.batch_size",)}


def _cli(argv, bert_calls):
    buf = io.StringIO()
    bert_calls.clear()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return buf.getvalue().splitlines()


def test_cli_train_and_eval_with_the_cache(tmp_path, monkeypatch):
    """The BERT body runs in the cache passes only: train over 8 + 8 stays
    (two minibatches of 4 per split), eval --drop-table over the 8 test
    stays (two), every drop-table condition from the cache."""
    calls = []
    real = BertEncoder.forward
    monkeypatch.setattr(BertEncoder, "forward", lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    sets = []
    for k, v in {**TINY_CLI, "data.synthetic_n": 8, "train.batch_size": 4, "train.min_epochs": 0,
                 "train.ckpt_every": 0, "encoder.text_embedding_cache": True}.items():
        sets += ["--set", f"{k}={v}"]
    out = str(tmp_path / "run")
    lines = _cli(["train", "--out", out, "--epochs", "1", "--device", "cpu", *sets], calls)
    assert any(line.startswith("[text-cache]") for line in lines) and len(calls) == 4
    assert json.loads(lines[-1])["epochs_ran"] == 1
    lines = _cli(["eval", "--ckpt", out, "--drop-table", "--device", "cpu"], calls)
    assert len(calls) == 2
    assert [line.split()[0] for line in lines if line.split()[:1] and line.split()[0] in
            ("full", "dropL", "dropN", "dropI", "rand1")] == ["full", "dropL", "dropN", "dropI", "rand1"]
    shutil.rmtree(out)  # ~0.2 GB of train state: keep the suite's disk small
