"""Bio-ClinicalBERT note encoder over chunk stacks (counterpart of
multimodalrouting_tpu/models/clinbert.py).

All B*S note chunks [B,S,L] run as one batched BERT-base forward (post-LN,
GELU FFN), aggregated per chunk (cls / masked mean / masked max), projected
with LayerNorm + Linear(hidden -> d, no bias) when hidden != d, zeroed on
padded chunks and pooled over chunks. Under the frozen-body default the BERT
runs under ``torch.no_grad`` and every attention layer is eligible for the
packed kernel K1. Fine-tuned (``finetune_text``), the body trains through
K1 and its backward K2 where the shape allows, with ``encoder.dropout``
after the embeddings, the attention and the FFN in training (a
``generator`` passed). A ``chunk_embs`` input (per-chunk embeddings before
the projection, precomputed by ``train/text_cache.py``) skips the body.

Chunk packing (``note_pack`` > 0, the capacity the train loop computes,
``train/loop.py:note_pack_bucket``): BERT sees only the valid chunks,
gathered to a [note_pack, L] buffer, and their embeddings are scattered back
to the [B*S] grid, where padded chunks are zeroed either way — the output is
the same as without packing. The JAX package passes the capacity through a
global context manager; here it is an argument.

On a mesh with ``n_model`` > 1 (the 'model' axis's default role, JAX
``clinbert.py:300-323``), rank j of a model group runs BERT on its
contiguous slice of the flattened, packed chunks (padded to equal length,
as GSPMD pads internally), and ``parallel/mesh.gather_chunks`` assembles
the [N, H] embeddings in rank order before the projection; its backward
hands each rank its rows of the gradient. Chunks are independent, so the
embeddings are those of the unsharded forward. Each slice draws its dropout
masks from a generator of its own (``slice_generator``).

Under the 'model' axis's ``tensor`` role (``train.tensor_parallel``,
``parallel/tp.py``) every rank of a model group runs BERT on all of the
data shard's chunks, and each ``BertLayer`` holds its slice of the layer's
weights: q/k/v and ``intermediate`` column-parallel behind Megatron's *f*,
``out_proj`` and ``output`` row-parallel, their partial sums added over the
group by *g* before the replicated bias, dropout, residual and LayerNorm.
The attention runs on the rank's heads (its dispatch decided on that local
shape), with head-local dropout from the rank's ``slice_generator``.

``pipeline`` (``train.pipeline_parallel``) holds the layers in the stacked
pipeline-parallel layout of ``parallel/pp.py`` (``bert.pp_layers``), with
that layout's own attention dispatch (no packed branch: K4a where the
segment-attention gate holds) and LayerNorm: a sequential loop on one card,
the GPipe schedule over the model group on a mesh under the ``pipeline``
role (``pp_microbatches`` microbatches per data shard, 0 for the stage
count), where every rank of the group runs it on all of the data shard's
chunks.

``remat`` (``model.remat``) recomputes each BERT layer's activations in the
backward instead of keeping them (``torch.utils.checkpoint``, the JAX
package's ``nn.remat``). A layer's dropout draws from the explicit
``generator``, which ``checkpoint``'s RNG preservation does not cover: the
layer's recompute starts the generator from the state its first run
started from, and puts back the state it found, so that the recomputed
masks are the first run's and later draws are unchanged.

``int8`` (``encoder.int8_text``) runs the six big matmuls of every layer as
int8 products (``ops/quant.QuantDense``, the same parameters as ``Dense``);
it is inference-only, so it refuses fine-tuned notes and the pipeline
layout with the JAX package's messages.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodalrouting_tpu_torch.models.attention import MultiheadAttention
from multimodalrouting_tpu_torch.models.layers import Dense, Embed, dropout
from multimodalrouting_tpu_torch.ops.gelu import apply_gelu
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm, bert_layer_norm
from multimodalrouting_tpu_torch.ops.masked import masked_max, masked_mean
from multimodalrouting_tpu_torch.ops.quant import QuantDense
from multimodalrouting_tpu_torch.parallel.mesh import (
    chunk_sharding,
    copy_to_model_group,
    gather_chunks,
    get_active_mesh,
    role_mesh,
    slice_generator,
)
from multimodalrouting_tpu_torch.parallel.pp import PipelinedBertLayers
from multimodalrouting_tpu_torch.parallel.tp import row_parallel, tp_self_attention
from multimodalrouting_tpu_torch.utils.profiling import count


class BertSelfAttentionBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, frozen_fast_path: bool, ln: str, dtype, dropout: float = 0.0,
                 int8: bool = False):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiheadAttention(hidden, heads, frozen_fast_path=frozen_fast_path, dropout=dropout, dtype=dtype,
                                       int8=int8)
        self.ln = bert_layer_norm(ln, hidden, 1e-12, dtype)

    def forward(self, x, attn_mask, generator=None):
        mesh = role_mesh("tensor")
        if mesh is None:
            h = self.attn(x, x, x, kv_mask=attn_mask, generator=generator)
        else:  # this rank's heads; the out-projection summed over the model group
            h = tp_self_attention(self.attn, x, attn_mask, generator, mesh)
        return self.ln(x + dropout(h, self.dropout, generator))


class BertLayer(nn.Module):
    def __init__(
        self, hidden: int, heads: int, intermediate: int, frozen_fast_path: bool = False,
        gelu: str = "erf", ln: str = "fp32", dtype=torch.float32, dropout: float = 0.0, int8: bool = False,
    ):
        super().__init__()
        self.gelu, self.dropout = gelu, dropout
        self.attention = BertSelfAttentionBlock(hidden, heads, frozen_fast_path, ln, dtype, dropout, int8)
        dense = QuantDense if int8 else Dense
        self.intermediate = dense(hidden, intermediate, dtype=dtype)
        self.output = dense(intermediate, hidden, dtype=dtype)
        self.ln = bert_layer_norm(ln, hidden, 1e-12, dtype)

    def forward(self, x, attn_mask, generator=None):
        x = self.attention(x, attn_mask, generator)
        mesh = role_mesh("tensor")
        if mesh is None:
            h = self.output(apply_gelu(self.intermediate(x), self.gelu))
        else:  # this rank's FFN features; the output product summed over the model group
            h = row_parallel(self.output, apply_gelu(self.intermediate(copy_to_model_group(x)), self.gelu), mesh)
        return self.ln(x + dropout(h, self.dropout, generator))


def remat_layer(layer: nn.Module, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(x, attn_mask, generator)`` with its activations recomputed in
    the backward; the recompute draws the first run's dropout masks from
    `generator` and leaves its state as it found it."""
    if generator is None:
        return checkpoint(layer, x, attn_mask, None, use_reentrant=False)
    start, runs = generator.get_state(), []

    def run(x, attn_mask):
        found = generator.get_state() if runs else None  # a recompute, after the first run
        runs.append(1)
        generator.set_state(start)
        try:
            return layer(x, attn_mask, generator)
        finally:
            if found is not None:
                generator.set_state(found)

    return checkpoint(run, x, attn_mask, use_reentrant=False)


class BertEncoder(nn.Module):
    """Token ids [N, L] -> hidden states [N, L, H]."""

    def __init__(
        self, vocab_size: int = 28996, hidden: int = 768, layers: int = 12, heads: int = 12,
        intermediate: int = 3072, max_position: int = 512, type_vocab: int = 2,
        frozen_fast_path: bool = False, gelu: str = "erf", ln: str = "fp32", dtype=torch.float32,
        dropout: float = 0.0, pipeline: bool = False, int8: bool = False, remat: bool = False,
        pp_microbatches: int = 0,
    ):
        super().__init__()
        self.layers, self.dropout, self.pipeline, self.remat = layers, dropout, pipeline, remat
        self.word_embeddings = Embed(vocab_size, hidden, dtype)
        self.position_embeddings = Embed(max_position, hidden, dtype)
        self.token_type_embeddings = Embed(type_vocab, hidden, dtype)
        self.embed_ln = bert_layer_norm(ln, hidden, 1e-12, dtype)
        if pipeline:  # the stacked pipeline-parallel layout (parallel/pp.py)
            if int8:
                raise ValueError("pipeline BERT does not compose with int8")
            self.pp_layers = PipelinedBertLayers(layers, hidden, heads, intermediate, gelu, dtype,
                                                 n_micro=pp_microbatches, remat=remat)
            return
        for i in range(layers):
            self.add_module(
                f"layer_{i}",
                BertLayer(hidden, heads, intermediate, frozen_fast_path, gelu, ln, dtype, dropout, int8),
            )

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, generator=None) -> torch.Tensor:
        _, length = input_ids.shape
        pos_ids = torch.arange(length, device=input_ids.device)[None, :]
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        x = dropout(self.embed_ln(x), self.dropout, generator)
        if self.pipeline:
            return self.pp_layers(x, attention_mask)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.layers):
            layer = getattr(self, f"layer_{i}")
            x = remat_layer(layer, x, attention_mask, generator) if remat else layer(x, attention_mask, generator)
        return x


class BioClinBERTEncoder(nn.Module):
    """notes {"input_ids" [B,S,L], "attention_mask" [B,S,L], "chunk_mask" [B,S],
    optional "chunk_embs" [B,S,hidden]} -> (H [B,S,d], chunk_mask [B,S], pooled [B,d])."""

    def __init__(
        self, d: int = 256, note_agg: str = "cls", chunk_agg: str = "mean",
        finetune_text: bool = False, gelu: str = "erf", ln: str = "fp32",
        vocab_size: int = 28996, hidden: int = 768, layers: int = 12, heads: int = 12,
        intermediate: int = 3072, max_position: int = 512, type_vocab: int = 2,
        dtype=torch.float32, dropout: float = 0.0, pipeline: bool = False, int8: bool = False,
        remat: bool = False, pp_microbatches: int = 0,
    ):
        super().__init__()
        if int8 and finetune_text:
            raise ValueError("int8 frozen-BERT path requires finetune_text=False (quantized matmuls are inference-only)")
        self.d, self.hidden, self.dtype = d, hidden, dtype
        self.note_agg, self.chunk_agg, self.finetune_text = note_agg, chunk_agg, finetune_text
        self.bert = BertEncoder(
            vocab_size, hidden, layers, heads, intermediate, max_position, type_vocab,
            frozen_fast_path=not finetune_text, gelu=gelu, ln=ln, dtype=dtype, dropout=dropout,
            pipeline=pipeline, int8=int8, remat=remat, pp_microbatches=pp_microbatches,
        )
        if d != hidden:
            self.proj_ln = LayerNorm(hidden, 1e-5, dtype)
            self.proj = Dense(hidden, d, bias=False, dtype=dtype)

    def forward(
        self, notes: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, note_pack: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        input_ids = notes["input_ids"]
        attn = notes["attention_mask"]
        if input_ids.dim() == 2:
            input_ids, attn = input_ids[:, None, :], attn[:, None, :]
        b, s, length = input_ids.shape
        chunk_mask = notes.get("chunk_mask")
        if chunk_mask is None:
            chunk_mask = attn.sum(dim=-1) > 0
        chunk_mask = chunk_mask.float()

        if notes.get("chunk_embs") is not None:
            if self.finetune_text:
                raise ValueError("notes['chunk_embs'] requires finetune_text=False")
            emb = notes["chunk_embs"].to(self.dtype).reshape(b * s, -1)
            return self._project_and_pool(emb, chunk_mask, b, s)

        flat_ids = input_ids.reshape(b * s, length)
        flat_attn = attn.reshape(b * s, length)
        pack_idx = None
        if 0 < note_pack < b * s:
            # valid chunks first (stable), then the capacity's padded slots
            pack_idx = torch.argsort(-chunk_mask.reshape(b * s), stable=True)[:note_pack]
            flat_ids, flat_attn = flat_ids[pack_idx], flat_attn[pack_idx]
        count("notes.slots", flat_ids.shape[0])  # the rows BERT runs, from the shape
        mesh = get_active_mesh()
        if chunk_sharding(mesh):
            # the 'model' axis's default role: this rank's contiguous slice of
            # the (packed) chunks, padded to equal length by repeating the last
            # chunk, through BERT; the gathered embeddings are trimmed back
            n = flat_ids.shape[0]
            per = -(-n // mesh.n_model)
            rows = torch.clamp(torch.arange(per, device=flat_ids.device) + mesh.model_index * per, max=n - 1)
            gen = slice_generator(generator, mesh.model_index)
            emb = gather_chunks(self.chunk_embeddings(flat_ids[rows], flat_attn[rows], gen))[:n]
        else:
            emb = self.chunk_embeddings(flat_ids, flat_attn, generator)
        return self._project_and_pool(emb, chunk_mask, b, s, pack_idx)

    def chunk_embeddings(self, flat_ids: torch.Tensor, flat_attn: torch.Tensor, generator=None) -> torch.Tensor:
        """The per-chunk BERT embedding before the projection, [N, hidden]
        for chunks [N, L] (what ``train/text_cache.py`` caches)."""
        with torch.set_grad_enabled(self.finetune_text and torch.is_grad_enabled()):
            hidden = self.bert(flat_ids, flat_attn, generator)  # [N, L, H]
            if self.note_agg == "cls":
                return hidden[:, 0]
            if self.note_agg == "max":
                return masked_max(hidden, flat_attn)
            return masked_mean(hidden, flat_attn)

    def _project_and_pool(self, emb, chunk_mask, b, s, pack_idx=None):
        if not self.finetune_text:
            emb = emb.detach()
        if self.d != self.hidden:
            emb = self.proj(self.proj_ln(emb))
        if pack_idx is not None:  # back to the [B*S] grid; unwritten slots stay zero
            emb = emb.new_zeros((b * s, emb.shape[-1])).index_copy(0, pack_idx, emb)
        h = emb.reshape(b, s, -1)
        h = h * chunk_mask[..., None].to(h.dtype)
        pooled = masked_max(h, chunk_mask) if self.chunk_agg == "max" else masked_mean(h, chunk_mask)
        return h, chunk_mask, pooled


# a BertLayer's modules -> HF BertLayer's
_HF_LAYER = {
    "attention.attn.q_proj": "attention.self.query",
    "attention.attn.k_proj": "attention.self.key",
    "attention.attn.v_proj": "attention.self.value",
    "attention.attn.out_proj": "attention.output.dense",
    "attention.ln": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense",
    "output": "output.dense",
    "ln": "output.LayerNorm",
}


def import_hf_bert_params(state_dict, layers: int) -> Dict[str, torch.Tensor]:
    """A HuggingFace BertModel state_dict (e.g. emilyalsentzer/Bio_ClinicalBERT)
    -> the layered ``BertEncoder`` state_dict keys, as CPU tensors. HF Linear
    weights are [out, in], as ``Dense`` holds them, so nothing is
    transposed; the pooler and any layer past `layers` are ignored."""

    def t(name: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).detach().cpu()

    out = {
        "word_embeddings.weight": t("embeddings.word_embeddings.weight"),
        "position_embeddings.weight": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings.weight": t("embeddings.token_type_embeddings.weight"),
        "embed_ln.weight": t("embeddings.LayerNorm.weight"),
        "embed_ln.bias": t("embeddings.LayerNorm.bias"),
    }
    for i in range(layers):
        for mine, theirs in _HF_LAYER.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{mine}.{leaf}"] = t(f"encoder.layer.{i}.{theirs}.{leaf}")
    return out
