"""Megatron-style tensor parallelism over the 'model' axis of the process
mesh (counterpart of multimodalrouting_tpu/parallel/tp.py).

Under ``train.tensor_parallel=true`` (the mesh's ``tensor`` role,
``parallel/mesh.py``) each rank of a model group holds a slice of every
BERT layer's weights instead of a slice of the note chunks:

- **column-parallel** (output features split, bias split): the q/k/v
  projections and the FFN ``intermediate`` product. The port's ``Dense``
  holds ``weight`` as [out, in], the transpose of flax's kernel, so the JAX
  package's ``P(None, 'model')`` kernel is dimension 0 here, as is the bias's
  ``P('model')``;
- **row-parallel** (input features split, bias replicated): the attention
  ``out_proj`` and the FFN ``output`` product, ``P('model', None)`` in the
  JAX package, dimension 1 of the port's weight;
- everything else replicated: the embeddings, the LayerNorms, the other
  encoders, MulT and the heads.

GSPMD inserts the collectives in the JAX package; here the BERT layer calls
them (``models/clinbert.py``): the layer's input enters each column-parallel
product through ``copy_to_model_group`` (Megatron's *f*), each
row-parallel product's partial sums are summed by
``reduce_from_model_group`` (*g*) before the replicated bias, dropout,
residual and LayerNorm. Each rank's attention runs on its ``heads / M``
heads of 64, so the attention dispatch (``models/attention.py``) decides on
the local shape: at BERT-base's 12 heads and M = 2 (6 heads, d = 384) the
packed kernels K1 / K2 take it; at M = 4 (3 heads, d = 192) K1's gate
fails (d % 128, an odd head count at 64) and the shape goes where the
dispatch sends it (``local_attention_branch``). Head-local dropout (the
attention weights) draws from the rank's ``slice_generator``.

Under ``encoder.int8_text`` a row-parallel product quantizes with the full
row's scales (an all-reduce max over the model group of the per-token
activation and per-channel weight maxima) and sums its int32 partial
products over the group before dequantizing, so that it equals
``ops/quant.QuantDense`` on the global tensors bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from multimodalrouting_tpu_torch.models.attention import attention, attention_branch, fused_qkv, use_fused_qkv
from multimodalrouting_tpu_torch.ops.quant import QuantDense, int8_matmul, int8_scale, quantize_with_scale
from multimodalrouting_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    copy_to_model_group,
    reduce_from_model_group,
    slice_generator,
)

# parameter owners inside a BERT layer, by sharding role (see module docstring)
_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "intermediate")
_ROW_PARALLEL = ("out_proj", "output")


def _is_bert_layer_name(names) -> bool:
    return "bert" in names and any(n.startswith("layer_") for n in names)


def tp_spec_for_name(name: str) -> Optional[int]:
    """The dimension of parameter `name` (a state_dict key) split over the
    model group, or None where it stays replicated."""
    names = name.split(".")
    if not _is_bert_layer_name(names) or len(names) < 2:
        return None
    leaf, owner = names[-1], names[-2]
    if owner in _COL_PARALLEL:
        return 0  # weight [out, in] and bias [out]: the output features
    if owner in _ROW_PARALLEL:
        return 1 if leaf == "weight" else None  # the input features; the bias is added once, replicated
    return None  # LayerNorms inside the layer stay replicated


def validate_tp_divisibility(cfg, n_model: int) -> None:
    """Shard-count divisibility: heads and FFN width must split evenly (the
    JAX package's check and message)."""
    e = cfg.encoder
    bad = []
    if e.bert_heads % n_model:
        bad.append(f"encoder.bert_heads={e.bert_heads}")
    if e.bert_hidden % n_model:
        bad.append(f"encoder.bert_hidden={e.bert_hidden}")
    if e.bert_intermediate % n_model:
        bad.append(f"encoder.bert_intermediate={e.bert_intermediate}")
    if bad:
        raise ValueError(
            f"train.tensor_parallel needs {', '.join(bad)} divisible by "
            f"model shards ({n_model})"
        )


def local_attention_branch(length: int, hidden: int, heads: int, n_model: int, *, frozen: bool) -> str:
    """The attention branch (``models/attention.attention_branch``) a tensor-
    parallel rank's BERT self-attention takes at `length` tokens: on its
    ``heads / n_model`` heads and ``hidden / n_model`` features, under a
    gradient unless `frozen`, without attention-weight dropout."""
    local, d = heads // n_model, hidden // n_model
    return attention_branch(length, length, d // local, d, local, frozen_fast_path=frozen, needs_grad=not frozen)


def row_parallel(dense, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-parallel product: `dense` holds this rank's input columns and
    `x` this rank's slice of the input; the partial products are summed over
    the model group, then the replicated bias is added."""
    if isinstance(dense, QuantDense):
        return _quant_row_parallel(dense, x, mesh)
    dt = dense.dtype
    y = reduce_from_model_group(F.linear(x.to(dt), dense.weight.to(dt)))
    return y if dense.bias is None else y + dense.bias.to(dt)


def _quant_row_parallel(dense: QuantDense, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``QuantDense`` of the global input on the global weight, from this
    rank's columns: the full rows' maxima (all-reduce max), the int32
    partial products summed over the group, then QuantDense's dequantization
    and bias. Inference only."""
    w32, x32 = dense.weight.float(), x.float()
    amax_w = all_reduce_(w32.abs().amax(dim=1, keepdim=True).contiguous(), mesh.model, op=dist.ReduceOp.MAX)
    amax_x = all_reduce_(x32.abs().amax(dim=-1, keepdim=True).contiguous(), mesh.model, op=dist.ReduceOp.MAX)
    s_w, s_x = int8_scale(amax_w), int8_scale(amax_x)
    acc = int8_matmul(quantize_with_scale(x32, s_x), quantize_with_scale(w32, s_w).t())
    y = all_reduce_(acc.contiguous(), mesh.model).float() * s_x * s_w.reshape(-1)
    if dense.bias is not None:
        y = y + dense.bias.float()
    return y.to(dense.dtype)


def tp_self_attention(attn, x: torch.Tensor, kv_mask, generator, mesh: Mesh) -> torch.Tensor:
    """A BERT ``MultiheadAttention`` on a tensor-parallel rank, before the
    residual: q/k/v column-parallel on this rank's heads (k and v one
    product over their column slices under ``MMR_FUSED_QKV=1``, as GSPMD
    shards the JAX package's fused kernel), the attention core on them, the
    out-projection row-parallel."""
    x = copy_to_model_group(x)
    gen = slice_generator(generator, mesh.model_index) if generator is not None and attn.dropout > 0 else generator
    scaling = (attn.d // attn.num_heads) ** -0.5
    if not attn.int8 and use_fused_qkv():
        qh, kh, vh = fused_qkv(attn.q_proj, attn.k_proj, attn.v_proj, x, scaling)
    else:
        qh, kh, vh = attn.q_proj(x) * scaling, attn.k_proj(x), attn.v_proj(x)
    out = attention(
        qh, kh, vh, kv_mask, None, attn.num_heads // mesh.n_model, frozen_fast_path=attn.frozen_fast_path,
        dtype=attn.dtype, dropout_rate=attn.dropout, generator=gen,
    )
    return row_parallel(attn.out_proj, out, mesh)
