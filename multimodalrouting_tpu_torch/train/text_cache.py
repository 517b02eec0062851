"""The frozen-BERT note-embedding cache, ``encoder.text_embedding_cache``
(counterpart of multimodalrouting_tpu/train/text_cache.py).

With the BERT body frozen (``finetune_text=False``) its inputs and weights
never change, so every epoch would recompute the same per-chunk embeddings;
the body is most of a frozen step. After the train state exists, the BERT
body runs once over each split, and the per-chunk embeddings are attached to
the split's ``Batch`` as ``note_chunk_embs``. The note encoder then skips
the body (``models/clinbert.py``, the ``chunk_embs`` path). What is cached
is the token-aggregated embedding of each chunk before the trainable
LayerNorm + Linear projection, so the projection and everything after it
still train.

The cache runs the model's own BERT weights, at the dtype they are held in
(bf16 under the frozen-text default with bf16 compute), in minibatches of
``train.batch_size`` on the model's device, and lives on the host, in the
compute dtype, with the rest of the split; each batch carries its slice to
the device. As in the JAX package, its encoder is built from the config
without ``encoder.bert_ln``, so its LayerNorms run the fp32 chain
(``ops/layernorm.py:layer_norm``) where the model's own run
``encoder.bert_ln`` (bf16 by default): cached and uncached forwards agree
to the rounding of that difference, exactly under ``encoder.bert_ln=fp32``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.models.clinbert import BioClinBERTEncoder


def find_bbert(model: nn.Module) -> Optional[nn.Module]:
    """The note encoder (the module named ``bbert``) anywhere in `model`."""
    for name, module in model.named_modules():
        if name.split(".")[-1] == "bbert":
            return module
    return None


def _encoder_from_cfg(cfg: Config, bbert: nn.Module) -> BioClinBERTEncoder:
    """The JAX package's cache encoder (no ``ln=``: the fp32 LayerNorm) on
    `bbert`'s device, holding `bbert`'s weights at their dtypes."""
    from multimodalrouting_tpu_torch.models.full import compute_dtype

    e = cfg.encoder
    with torch.device("meta"):
        enc = BioClinBERTEncoder(
            d=e.d, note_agg=e.note_agg, chunk_agg=e.note_chunk_agg, finetune_text=False, gelu=e.bert_gelu,
            vocab_size=e.bert_vocab_size, hidden=e.bert_hidden, layers=e.bert_layers, heads=e.bert_heads,
            intermediate=e.bert_intermediate, max_position=e.bert_max_position, type_vocab=e.bert_type_vocab,
            dtype=compute_dtype(cfg), dropout=e.dropout, pipeline=cfg.train.pipeline_parallel, int8=e.int8_text,
            remat=cfg.model.remat,
        )
    weights = bbert.state_dict()
    enc.to_empty(device=next(bbert.parameters()).device)
    for name, p in enc.named_parameters():
        p.data = p.data.to(weights[name].dtype)
    enc.load_state_dict(weights)
    return enc.eval()


def compute_note_chunk_embs(cfg: Config, model: nn.Module, cohort: Batch, *, batch_size: int = 0) -> torch.Tensor:
    """The frozen BERT body once over `cohort` -> [N, S, hidden] on the host,
    with `model`'s note-encoder weights, in minibatches of `batch_size`
    (default ``train.batch_size``)."""
    bbert = find_bbert(model)
    if bbert is None:
        raise ValueError("no 'bbert' module in the model: it has no note encoder to cache")
    enc = _encoder_from_cfg(cfg, bbert)
    dev = next(enc.parameters()).device
    n = cohort.batch_size
    bs = batch_size if batch_size > 0 else min(n, max(cfg.train.batch_size, 1))
    out = []
    with torch.inference_mode():
        for start in range(0, n, bs):
            ids = torch.as_tensor(cohort.note_ids[start : start + bs]).to(dev)
            attn = torch.as_tensor(cohort.note_attn[start : start + bs]).to(dev)
            b, s, length = ids.shape
            emb = enc.chunk_embeddings(ids.reshape(b * s, length), attn.reshape(b * s, length))
            out.append(emb.reshape(b, s, -1).cpu())
    return torch.cat(out, dim=0)


def attach_note_cache(cfg: Config, model: nn.Module, cohort: Batch, *, batch_size: int = 0) -> Batch:
    """`cohort` with ``note_chunk_embs`` attached."""
    if cfg.encoder.finetune_text:
        raise ValueError(
            "encoder.text_embedding_cache requires finetune_text=False — "
            "a fine-tuned BERT body invalidates the cache every step"
        )
    return cohort._replace(note_chunk_embs=compute_note_chunk_embs(cfg, model, cohort, batch_size=batch_size))
