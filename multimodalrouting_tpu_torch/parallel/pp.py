"""The pipeline-parallel layout of the chunk-BERT layer stack and its GPipe
schedule over the 'model' axis of the process mesh (counterpart of
multimodalrouting_tpu/parallel/pp.py).

A checkpoint trained with ``train.pipeline_parallel=true`` holds its BERT
layers stacked on a leading [n_layers, ...] axis under ``bert.pp_layers``,
with the flax leaf names and [in, out] kernels (``q_kernel``, ``q_bias``,
..., ``ln_bias``). ``PipelinedBertLayers`` declares exactly those
parameters. Without a mesh whose 'model' axis has the ``pipeline`` role it
runs the layers as a sequential loop, as the JAX package runs
``_scan_layers`` without a mesh, so a pipeline-layout checkpoint evaluates
and serves on a single card unchanged. On such a mesh (``parallel/mesh.py``,
``train.pipeline_parallel`` with M > 1 model shards) rank j of a model
group holds stage j, layers [j·L/M, (j+1)·L/M) of the stack
(``pp_spec_for_name``, ``mesh.place_state``), and ``pipeline_apply`` runs
the GPipe schedule: the data shard's chunks, cut into m microbatches, flow
through the stages, one point-to-point hop (``mesh.exchange``) from stage
s to s + 1 a microbatch; the backward runs the ticks in reverse with the
inverse hops. ``model.remat`` recomputes each layer's activations in the
backward (``torch.utils.checkpoint``), as the JAX package's
``jax.checkpoint`` does.

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

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.ops import flash
from multimodalrouting_tpu_torch.ops.gelu import apply_gelu
from multimodalrouting_tpu_torch.ops.masked import NEG_INF
from multimodalrouting_tpu_torch.parallel.mesh import (
    Mesh,
    copy_to_model_group,
    exchange,
    reduce_from_model_group,
    role_mesh,
)

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


def _scan_layers(w_stacked, x, kv_mask, *, heads: int, dtype, gelu: str = "erf", remat: bool = False):
    """The stacked layers in order; with `remat` each layer's activations
    are recomputed in the backward (the JAX package's ``jax.checkpoint`` of
    the scan step). The layers draw no random numbers, so the recompute is
    exact."""
    remat = remat and torch.is_grad_enabled()
    for i in range(int(w_stacked["q_kernel"].shape[0])):
        w = {name: v[i] for name, v in w_stacked.items()}
        if remat:
            x = checkpoint(bert_layer_fwd, w, x, kv_mask, heads=heads, dtype=dtype, gelu=gelu, use_reentrant=False)
        else:
            x = bert_layer_fwd(w, x, kv_mask, heads=heads, dtype=dtype, gelu=gelu)
    return x


def micro_count(n_loc: int, n_micro: int) -> int:
    """Microbatches of a data shard's `n_loc` chunks: `n_micro` at most,
    lowered until it divides them (the JAX package's rule)."""
    m = max(1, min(int(n_micro), n_loc))
    while n_loc % m:
        m -= 1
    return m


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """The static part of one pipelined call."""

    mesh: Mesh
    m: int  # microbatches
    heads: int
    dtype: Any
    gelu: str
    remat: bool
    grad: bool  # whether to keep each tick's graph for the backward


def _active(t: int, stage: int, m: int) -> bool:
    """Whether `stage` holds a microbatch at tick `t` (microbatch t - stage)."""
    return 0 <= t - stage < m


class _GPipe(torch.autograd.Function):
    """The whole schedule of this rank's stage as one autograd node, so that
    every rank posts its hops in one fixed order in the forward and in the
    backward alike (two-sided point-to-point in an order the autograd engine
    chose per rank could deadlock).

    Tick t (0 <= t < m + S - 1): stage s runs its layers on microbatch
    t - s where 0 <= t - s < m, and skips its bubble ticks (outside that
    range), where the JAX package computes on discarded values: those carry
    neither value nor gradient, so skipping them changes no number, and
    each stage launches its layers' attention m times a step, not
    m + S - 1. Stage 0 takes microbatch t from the input; the others receive
    their input from stage s - 1's output of the tick before; the last
    stage's outputs are the result (zeros on the other stages). The
    backward walks the ticks in reverse: the last stage takes the result's
    gradient, the others receive their output's gradient from stage s + 1,
    and each tick's ``autograd.grad`` gives the gradient of the tick's input
    (sent to stage s - 1, or the input's own on stage 0) and of this
    stage's leaves."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, mask, *leaves):
        mesh, m = sched.mesh, sched.m
        n_stages, stage = mesh.n_model, mesh.model_index
        n, length, hidden = x.shape
        mb = n // m
        xs, masks = x.reshape(m, mb, length, hidden), mask.reshape(m, mb, length)
        w = {name: leaf.detach().requires_grad_(sched.grad) for name, leaf in zip(LEAVES, leaves)}
        out = torch.zeros((m, mb, length, hidden), dtype=sched.dtype, device=x.device)
        ticks = {}
        act = res = None
        for t in range(m + n_stages - 1):
            j = t - stage
            if _active(t, stage, m):
                inp = (xs[j] if stage == 0 else act).detach().requires_grad_(sched.grad)
                with torch.set_grad_enabled(sched.grad):
                    res = _scan_layers(w, inp, masks[j], heads=sched.heads, dtype=sched.dtype, gelu=sched.gelu,
                                       remat=sched.remat)
                if sched.grad:
                    ticks[t] = (inp, res)
                if stage == n_stages - 1:
                    out[j] = res.detach()
            if t < m + n_stages - 2:  # the hop: stage s's output of tick t is stage s + 1's input at t + 1
                send = stage < n_stages - 1 and _active(t, stage, m)
                recv = stage > 0 and _active(t + 1, stage, m)
                # a new buffer each time: the last one is the saved input of a tick's graph
                act = torch.empty((mb, length, hidden), dtype=sched.dtype, device=x.device) if recv else None
                exchange(res.detach() if send else None, _world_rank(mesh, stage + 1), act,
                         _world_rank(mesh, stage - 1))
        ctx.sched, ctx.ticks, ctx.w, ctx.shape = sched, ticks, w, (m, mb, length, hidden)
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out.reshape(n, length, hidden)

    @staticmethod
    def backward(ctx, g_out):
        sched, ticks, w = ctx.sched, ctx.ticks, ctx.w
        mesh, m = sched.mesh, sched.m
        n_stages, stage = mesh.n_model, mesh.model_index
        g_out = g_out.reshape(ctx.shape)
        shape, dtype, device = ctx.x_meta
        g_x = torch.zeros(shape, dtype=dtype, device=device).reshape(ctx.shape)
        g_w = {name: torch.zeros_like(v) for name, v in w.items()}
        g_in = None  # the gradient of this stage's input at the tick after
        for t in reversed(range(m + n_stages - 1)):
            j = t - stage
            g_res = None
            if t < m + n_stages - 2:  # the inverse hop of tick t's
                send = stage > 0 and _active(t + 1, stage, m)
                recv = stage < n_stages - 1 and _active(t, stage, m)
                if recv:
                    g_res = torch.empty(ctx.shape[1:], dtype=sched.dtype, device=device)
                exchange(g_in if send else None, _world_rank(mesh, stage - 1), g_res,
                         _world_rank(mesh, stage + 1))
            if _active(t, stage, m):
                inp, res = ticks.pop(t)
                g = g_out[j] if stage == n_stages - 1 else g_res
                grads = torch.autograd.grad(res, [inp, *w.values()], g.to(res.dtype))
                g_in = grads[0]
                for acc, gw in zip(g_w.values(), grads[1:]):
                    acc.add_(gw)
                if stage == 0:
                    g_x[j] = g_in
        return (None, g_x.reshape(shape), None, *g_w.values())


def _world_rank(mesh: Mesh, stage: int) -> Optional[int]:
    """The world rank of `stage` in this rank's model group (None outside
    the stages)."""
    return mesh.data_index * mesh.n_model + stage if 0 <= stage < mesh.n_model else None


def pipeline_apply(w_local: Dict[str, torch.Tensor], x: torch.Tensor, attn_mask: torch.Tensor, *, mesh: Mesh,
                   n_micro: int, heads: int, dtype, gelu: str = "erf", remat: bool = False) -> torch.Tensor:
    """The GPipe schedule over `mesh`'s model group (the JAX package's
    ``pipeline_apply``, :195-275).

    `x` [n, L, H]: the embedded chunks of this rank's data shard, the same
    on every rank of the model group; `w_local`: this stage's stacked
    leaves, [n_layers / M, ...]. The n chunks run as ``micro_count(n,
    n_micro)`` microbatches. Returns the stack's output [n, L, H],
    replicated over the model group.

    The input enters through ``copy_to_model_group`` (Megatron's *f*): only
    stage 0 reads it, and the sum of the stages' gradients over the group
    hands every rank the whole gradient of the embedded chunks, as the JAX
    package's ``shard_map`` transpose sums it over 'model'. The last
    stage's outputs are replicated by ``reduce_from_model_group`` (*g*, the
    JAX package's ``psum`` of ``out``: a sum forward, the identity
    backward), so every stage receives the result's whole gradient and the
    last one uses it."""
    m = micro_count(x.shape[0], n_micro)
    grad = torch.is_grad_enabled() and (x.requires_grad or any(v.requires_grad for v in w_local.values()))
    sched = _Schedule(mesh, m, heads, dtype, gelu, remat, grad)
    x = copy_to_model_group(x)
    out = _GPipe.apply(sched, x, attn_mask, *(w_local[name] for name in LEAVES))
    return reduce_from_model_group(out)


def pp_spec_for_name(name: str) -> Optional[int]:
    """The dimension of parameter `name` split over the model group under
    the ``pipeline`` role: the leading (layer) axis of every stacked
    ``pp_layers`` leaf, so that each stage holds its layers; None (replicated)
    elsewhere (the JAX package's ``pp_spec_for_path``)."""
    return 0 if "pp_layers" in name.split(".") else None


class PipelinedBertLayers(nn.Module):
    """The BERT layer stack with stacked [n_layers, ...] parameters under the
    flax names: the GPipe schedule on a mesh whose 'model' axis has the
    ``pipeline`` role and more than one shard (its leaves then this stage's
    slice), the sequential loop otherwise. `n_micro` microbatches per data
    shard (0: the stage count), `remat` per-layer recomputation."""

    def __init__(self, layers: int, hidden: int, heads: int, intermediate: int, gelu: str = "erf",
                 dtype=torch.float32, n_micro: int = 0, remat: bool = False):
        super().__init__()
        self.heads, self.gelu, self.dtype, self.n_micro, self.remat = heads, gelu, dtype, n_micro, remat
        h, i, n = hidden, intermediate, layers
        # per-slice kernels, as the layered BERT draws them: the attention
        # projections xavier_uniform, the FFN flax's default lecun_normal
        xavier, lecun = init.stacked(init.xavier_uniform), init.stacked(init.lecun_normal)
        spec = {
            "q_kernel": ((n, h, h), xavier), "q_bias": ((n, h), init.zeros),
            "k_kernel": ((n, h, h), xavier), "k_bias": ((n, h), init.zeros),
            "v_kernel": ((n, h, h), xavier), "v_bias": ((n, h), init.zeros),
            "o_kernel": ((n, h, h), xavier), "o_bias": ((n, h), init.zeros),
            "attn_ln_scale": ((n, h), init.ones), "attn_ln_bias": ((n, h), init.zeros),
            "i_kernel": ((n, h, i), lecun), "i_bias": ((n, i), init.zeros),
            "f_kernel": ((n, i, h), lecun), "f_bias": ((n, h), init.zeros),
            "ln_scale": ((n, h), init.ones), "ln_bias": ((n, h), init.zeros),
        }
        for name, (shape, initializer) in spec.items():
            init.param(self, name, initializer, shape)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        w = {name: getattr(self, name) for name in LEAVES}
        mesh = role_mesh("pipeline")
        if mesh is not None and mesh.n_model > 1:
            return pipeline_apply(w, x, attn_mask, mesh=mesh, n_micro=self.n_micro or mesh.n_model, heads=self.heads,
                                  dtype=self.dtype, gelu=self.gelu, remat=self.remat)
        return _scan_layers(w, x, attn_mask, heads=self.heads, dtype=self.dtype, gelu=self.gelu, remat=self.remat)


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
