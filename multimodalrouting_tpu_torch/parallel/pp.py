"""The pipeline-parallel layout of the chunk-BERT layer stack, on one card
(counterpart of multimodalrouting_tpu/parallel/pp.py:46-192, :278-359 and
:362-389).

A checkpoint trained with ``train.pipeline_parallel=true`` holds its BERT
layers stacked on a leading [n_layers, ...] axis under ``bert.pp_layers``,
with the flax leaf names and [in, out] kernels (``q_kernel``, ``q_bias``,
..., ``ln_bias``). ``PipelinedBertLayers`` declares exactly those
parameters. Without a device mesh (always, on one card) it runs the layers
as a sequential loop, as the JAX package runs ``_scan_layers`` without a
mesh, so a pipeline-layout checkpoint evaluates and serves on a single card
unchanged. The GPipe schedule over several cards (``pipeline_apply``) is not
ported and raises.

Each layer is functional (``bert_layer_fwd``) and differs from the layered
``BertLayer`` as the JAX package's does:

- ``_layer_norm`` keeps its own fp32-statistics order (x - mean times
  rsqrt in fp32, cast to the compute dtype, then the affine in it),
  whatever ``encoder.bert_ln`` says;
- ``_self_attention`` has no packed branch: it takes K4a (or K4b under
  MMR_ATTN=splash, ``ops/flash.py``) wherever ``flash.supports`` holds, and
  the eager attention elsewhere;
- no dropout inside the layers.

``stack_bert_layer_params``, ``unstack_bert_layer_params``, ``to_pp_layout``
and ``from_pp_layout`` convert between the layered ``layer_i.*`` state_dict
keys (Linear weights [out, in]) and the stacked ``pp_layers.*`` ones;
``ckpt.load_weights`` applies them wherever a checkpoint and the model
disagree, in either direction.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.ops import flash
from multimodalrouting_tpu_torch.ops.gelu import apply_gelu
from multimodalrouting_tpu_torch.ops.masked import NEG_INF

# stacked leaf -> (key inside one layered BertLayer, whether it is a Linear
# weight [out, in] that the stacked layout holds as a kernel [in, out])
_LEAF_KEYS: Dict[str, tuple] = {
    "q_kernel": ("attention.attn.q_proj.weight", True),
    "q_bias": ("attention.attn.q_proj.bias", False),
    "k_kernel": ("attention.attn.k_proj.weight", True),
    "k_bias": ("attention.attn.k_proj.bias", False),
    "v_kernel": ("attention.attn.v_proj.weight", True),
    "v_bias": ("attention.attn.v_proj.bias", False),
    "o_kernel": ("attention.attn.out_proj.weight", True),
    "o_bias": ("attention.attn.out_proj.bias", False),
    "attn_ln_scale": ("attention.ln.weight", False),
    "attn_ln_bias": ("attention.ln.bias", False),
    "i_kernel": ("intermediate.weight", True),
    "i_bias": ("intermediate.bias", False),
    "f_kernel": ("output.weight", True),
    "f_bias": ("output.bias", False),
    "ln_scale": ("ln.weight", False),
    "ln_bias": ("ln.bias", False),
}
LEAVES = tuple(_LEAF_KEYS)


def stack_bert_layer_params(bert_sd: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """Layered ``layer_i.*`` keys of a BertEncoder state_dict -> the stacked
    ``pp_layers`` leaves (by leaf name)."""
    out = {}
    for name, (key, is_kernel) in _LEAF_KEYS.items():
        xs = [bert_sd[f"layer_{i}.{key}"] for i in range(n_layers)]
        out[name] = torch.stack([x.t() if is_kernel else x for x in xs]).contiguous()
    return out


def unstack_bert_layer_params(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stacked ``pp_layers`` leaves -> layered ``layer_i.*`` keys."""
    out = {}
    for i in range(int(leaves["q_kernel"].shape[0])):
        for name, (key, is_kernel) in _LEAF_KEYS.items():
            x = leaves[name][i]
            out[f"layer_{i}.{key}"] = (x.t() if is_kernel else x).contiguous()
    return out


def to_pp_layout(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A state_dict whose BertEncoder under `prefix` is layered -> the same
    with that encoder's layers stacked under ``prefix + "pp_layers."``. Other
    keys (the embeddings, the rest of the model) pass through."""
    head = prefix + "layer_"
    rel = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(head)}
    n_layers = sum(1 for k in rel if k.endswith(".attention.attn.q_proj.weight"))
    if len(rel) != n_layers * len(_LEAF_KEYS):
        raise KeyError(f"{len(rel)} layer keys under {prefix!r} for {n_layers} BERT layers of {len(_LEAF_KEYS)}")
    out = {k: v for k, v in sd.items() if not k.startswith(head)}
    out.update({f"{prefix}pp_layers.{name}": v for name, v in stack_bert_layer_params(rel, n_layers).items()})
    return out


def from_pp_layout(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of ``to_pp_layout``."""
    head = prefix + "pp_layers."
    leaves = {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}
    out = {k: v for k, v in sd.items() if not k.startswith(head)}
    out.update({prefix + k: v for k, v in unstack_bert_layer_params(leaves).items()})
    return out


def _dense(x, kernel, bias, dtype):
    """x @ kernel + bias in the compute dtype, the bias added in the GEMM's
    epilogue as the layered Dense adds it."""
    return F.linear(x.to(dtype), kernel.to(dtype).t(), bias.to(dtype))


def _layer_norm(x, scale, bias, dtype, eps: float = 1e-12):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dtype) * scale.to(dtype) + bias.to(dtype)


def _self_attention(w, x, kv_mask, heads: int, dtype):
    n, length, hidden = x.shape
    hd = hidden // heads
    q = (_dense(x, w["q_kernel"], w["q_bias"], dtype) * (hd**-0.5)).reshape(n, length, heads, hd)
    k = _dense(x, w["k_kernel"], w["k_bias"], dtype).reshape(n, length, heads, hd)
    v = _dense(x, w["v_kernel"], w["v_bias"], dtype).reshape(n, length, heads, hd)
    impl = flash.attention_impl()
    if impl != "xla" and flash.supports(length, length, hd):
        kernel = flash.splash_self_attention if impl == "splash" else flash.flash_self_attention
        out = kernel(q, k, v, kv_mask).to(dtype)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        keep = kv_mask.bool()[:, None, None, :]
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1).to(dtype), v)
    return _dense(out.reshape(n, length, hidden), w["o_kernel"], w["o_bias"], dtype)


def bert_layer_fwd(w, x, kv_mask, *, heads: int, dtype, gelu: str = "erf"):
    """One BertLayer forward on a dict of one layer's leaves (dropout-free,
    as the JAX package's pipelined stack is)."""
    h = _self_attention(w, x, kv_mask, heads, dtype)
    x = _layer_norm(x + h, w["attn_ln_scale"], w["attn_ln_bias"], dtype)
    h = apply_gelu(_dense(x, w["i_kernel"], w["i_bias"], dtype), gelu)
    h = _dense(h, w["f_kernel"], w["f_bias"], dtype)
    return _layer_norm(x + h, w["ln_scale"], w["ln_bias"], dtype)


def _scan_layers(w_stacked, x, kv_mask, *, heads: int, dtype, gelu: str = "erf"):
    for i in range(int(w_stacked["q_kernel"].shape[0])):
        x = bert_layer_fwd({name: w[i] for name, w in w_stacked.items()}, x, kv_mask,
                           heads=heads, dtype=dtype, gelu=gelu)
    return x


def pipeline_apply(*args, **kwargs):
    """The GPipe schedule over the 'model' axis of a device mesh."""
    raise NotImplementedError(
        "the pipelined schedule over several cards is not ported yet (ROADMAP.md, parallel modes)"
    )


class PipelinedBertLayers(nn.Module):
    """The BERT layer stack with stacked [n_layers, ...] parameters under the
    flax names; a sequential loop over the layers (there is no mesh on one
    card)."""

    def __init__(self, layers: int, hidden: int, heads: int, intermediate: int, gelu: str = "erf",
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.gelu, self.dtype = heads, gelu, dtype
        h, i, n = hidden, intermediate, layers
        shapes = {
            "q_kernel": (n, h, h), "q_bias": (n, h), "k_kernel": (n, h, h), "k_bias": (n, h),
            "v_kernel": (n, h, h), "v_bias": (n, h), "o_kernel": (n, h, h), "o_bias": (n, h),
            "attn_ln_scale": (n, h), "attn_ln_bias": (n, h), "i_kernel": (n, h, i), "i_bias": (n, i),
            "f_kernel": (n, i, h), "f_bias": (n, h), "ln_scale": (n, h), "ln_bias": (n, h),
        }
        for name, shape in shapes.items():
            if name.endswith("_kernel"):
                w = torch.empty(shape)
                for layer in w:  # per-slice init, as the layered Dense
                    nn.init.xavier_uniform_(layer)
            elif name.endswith("_scale"):
                w = torch.ones(shape)
            else:
                w = torch.zeros(shape)
            self.register_parameter(name, nn.Parameter(w))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        w = {name: getattr(self, name) for name in LEAVES}
        return _scan_layers(w, x, attn_mask, heads=self.heads, dtype=self.dtype, gelu=self.gelu)


def validate_pp(cfg, n_model: int) -> None:
    """The JAX package's checks before a pipeline-parallel run, with its
    messages."""
    t = cfg.train
    e = cfg.encoder
    if t.tensor_parallel:
        raise ValueError(
            "train.pipeline_parallel and train.tensor_parallel both claim the "
            "'model' mesh axis — pick one"
        )
    if n_model < 2:
        raise ValueError(
            "train.pipeline_parallel needs train.num_model_shards >= 2 "
            f"(got {n_model}); with one shard there is nothing to pipeline"
        )
    if e.bert_layers % n_model:
        raise ValueError(
            f"train.pipeline_parallel needs encoder.bert_layers="
            f"{e.bert_layers} divisible by model shards ({n_model})"
        )
    if e.int8_text:
        raise ValueError("train.pipeline_parallel does not compose with encoder.int8_text")
    if e.dropout > 0.0:
        raise ValueError(
            "the pipelined BERT stack is dropout-free; set encoder.dropout=0 "
            "to use train.pipeline_parallel"
        )
