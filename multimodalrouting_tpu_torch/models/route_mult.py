"""The per-route MulT family: one full MulT stack per directional route
(counterpart of multimodalrouting_tpu/models/route_mult.py; the reference's
PhenoModel/routing_and_heads_atten.py:81-262), selected by
``model.bi_fusion_mode=mult`` with 10 routes (``configs/pheno_atten_mult.yaml``).

- ``PerRouteMulTFusion``: the unimodal routes are the encoders' pools; the
  six directional routes (LN, NL, LI, IL, NI, IN: the first modality
  attends over the second) run as one stacked module of six MulT stacks,
  ``directional``, each pooled at its query's last valid step; the LNI
  route is ``MulTTriFusion``.
- ``MulTTriFusion``: the streams L<-N, L<-I, I<-N as one stacked module,
  ``streams``; each pooled at its query's literal last native step, masks
  ignored; concatenated in the reference's order [LN, IN, LI], then
  ``final`` Dense(3d -> d).
- ``MulTCrossAttentionFusion``: one directional route alone (a stack of
  one stream, ``trans``), as the reference builds each.

Sequences of unequal length are padded to a common T. Only the extension
is masked out of the keys (and the queries): each sequence's own data pads
are attended, as the reference attends padded positions of B. The causal
mask is a per-stream bias with each stream's native offset 1 + |Tk - Tq|
(``_native_causal_bias``), so the stack itself runs without ``causal``.

Under the 'model' axis's ``route`` role (``train.route_parallel``,
``parallel/ep.py``) this rank holds and runs its slice of ``directional``
(its streams' causal biases with them): the replicated sequences enter
through ``copy_to_model_group``, the stream-local dropout draws from the
rank's ``slice_generator``, and ``gather_streams`` assembles the six
outputs before the pooling; the tri route stays replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodalrouting_tpu_torch.models.layers import Dense
from multimodalrouting_tpu_torch.models.mult import _pad_time
from multimodalrouting_tpu_torch.models.transformer import StackedMulTEncoder
from multimodalrouting_tpu_torch.ops.masked import NEG_INF
from multimodalrouting_tpu_torch.parallel.mesh import (
    copy_to_model_group,
    gather_streams,
    role_mesh,
    slice_generator,
    stream_slice,
)

#: (query, kv) modality per directional route, the reference's build order
#: (L=0, N=1, I=2)
DIRECTIONAL_STREAMS: Tuple[Tuple[int, int], ...] = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))
DIRECTIONAL_NAMES = ("LN", "NL", "LI", "IL", "NI", "IN")
#: the tri route's streams: L<-N, L<-I, I<-N
TRI_STREAMS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (2, 1))


def _native_causal_bias(streams, t_nat: Sequence[int], t_max: int, causal: bool) -> torch.Tensor:
    """Per-stream additive bias [G, T_max, T_max]: each stream's causal
    offset 1 + |Tk - Tq| at its native lengths, on the padded grid; zeros
    without the causal mask."""
    if not causal:
        return torch.zeros(len(streams), t_max, t_max)
    i = np.arange(t_max)[:, None]
    j = np.arange(t_max)[None, :]
    biases = [np.where(j >= i + 1 + abs(t_nat[kv] - t_nat[q]), NEG_INF, 0.0) for q, kv in streams]
    return torch.from_numpy(np.stack(biases).astype(np.float32))


def _last_valid(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's last-step pooling: each row's last valid step under
    `mask`, row 0 where the mask is empty (not zeros); the last step
    without a mask."""
    if mask is None:
        return x[:, -1]
    idx = ((mask > 0.5).sum(dim=1) - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _stacked(g: int, d: int, n_heads: int, layers: int, positions: str, use_positional: bool, dtype,
             attn_dropout: float, relu_dropout: float, res_dropout: float, embed_dropout: float, causal=False):
    return StackedMulTEncoder(
        g, d, n_heads, layers, causal=causal, positions=positions, dtype=dtype, attn_dropout=attn_dropout,
        relu_dropout=relu_dropout, res_dropout=res_dropout, embed_dropout=embed_dropout,
        use_positional=use_positional,
    )


def _streams(seqs, streams, t_max: int):
    """The streams' query and key sequences [G, B, T, d] and extension
    masks [G, B, T] (1 on each sequence's native steps, data pads
    included; 0 on the padding to t_max)."""
    b = seqs[0].shape[0]
    padded, ext = [], []
    for s in seqs:
        ps, pe = _pad_time(s, torch.ones(b, s.shape[1], device=s.device), t_max)
        padded.append(ps)
        ext.append(pe)
    q_idx = [q for q, _ in streams]
    kv_idx = [kv for _, kv in streams]
    stack = lambda xs, idx: torch.stack([xs[i] for i in idx])  # noqa: E731
    return stack(padded, q_idx), stack(padded, kv_idx), stack(ext, q_idx), stack(ext, kv_idx)


class MulTCrossAttentionFusion(nn.Module):
    """One directional route: A attends over B through a full MulT stack
    (causal by default), pooled at A's last valid step. B's mask is taken
    and not used: the reference attends B's padded positions."""

    def __init__(self, d: int, n_heads: int = 8, layers: int = 1, attn_mask: bool = True,
                 use_positional: bool = True, positions: str = "sinusoidal", dtype=torch.float32,
                 attn_dropout: float = 0.0, relu_dropout: float = 0.0, res_dropout: float = 0.0,
                 embed_dropout: float = 0.0):
        super().__init__()
        self.trans = _stacked(1, d, n_heads, layers, positions, use_positional, dtype, attn_dropout,
                              relu_dropout, res_dropout, embed_dropout, causal=attn_mask)

    def forward(self, a_seq, a_mask, b_seq, b_mask=None, generator=None):
        del b_mask
        h = self.trans(a_seq[None], b_seq[None], b_seq[None], generator=generator)[0]
        return _last_valid(h, a_mask)


class MulTTriFusion(nn.Module):
    """The trimodal route: L<-N, L<-I, I<-N, the literal last native step of
    each, concatenated [LN, IN, LI] -> Dense(3d -> d) ``final``."""

    def __init__(self, d: int, n_heads: int = 8, layers: int = 1, attn_mask: bool = False,
                 use_positional: bool = True, positions: str = "sinusoidal", dtype=torch.float32,
                 attn_dropout: float = 0.0, relu_dropout: float = 0.0, res_dropout: float = 0.0,
                 embed_dropout: float = 0.0):
        super().__init__()
        self.attn_mask = attn_mask
        self.streams = _stacked(len(TRI_STREAMS), d, n_heads, layers, positions, use_positional, dtype,
                                attn_dropout, relu_dropout, res_dropout, embed_dropout)
        self.final = Dense(3 * d, d, dtype=dtype)

    def forward(self, l_seq, l_mask, n_seq, n_mask, i_seq, i_mask, generator=None):
        del l_mask, n_mask, i_mask  # the reference pools h[-1] whatever the masks say
        seqs = (l_seq, n_seq, i_seq)
        t_nat = [s.shape[1] for s in seqs]
        t_max = max(t_nat)
        q, kv, q_ext, kv_ext = _streams(seqs, TRI_STREAMS, t_max)
        bias = _native_causal_bias(TRI_STREAMS, t_nat, t_max, self.attn_mask).to(l_seq.device)
        h = self.streams(q, kv, kv, q_ext, kv_ext, generator=generator, attn_bias=bias)
        last = [h[g][:, t_nat[qi] - 1] for g, (qi, _) in enumerate(TRI_STREAMS)]  # LN, LI, IN
        return self.final(torch.cat([last[0], last[2], last[1]], dim=-1))


class PerRouteMulTFusion(nn.Module):
    """The 10 routes of the per-route MulT family -> {route: [B, d]}."""

    def __init__(self, d: int, n_heads: int = 8, layers: int = 1, attn_mask: bool = True,
                 use_positional: bool = True, positions: str = "sinusoidal", dtype=torch.float32,
                 attn_dropout: float = 0.0, relu_dropout: float = 0.0, res_dropout: float = 0.0,
                 embed_dropout: float = 0.0):
        super().__init__()
        self.attn_mask = attn_mask
        common = dict(positions=positions, use_positional=use_positional, dtype=dtype, attn_dropout=attn_dropout,
                      relu_dropout=relu_dropout, res_dropout=res_dropout, embed_dropout=embed_dropout)
        self.directional = _stacked(len(DIRECTIONAL_STREAMS), d, n_heads, layers, **common)
        self.LNI = MulTTriFusion(d, n_heads, layers, attn_mask=attn_mask, **common)

    def forward(self, l_seq, l_mask, l_pool, n_seq, n_mask, n_pool, i_seq, i_mask, i_pool,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        seqs, masks = (l_seq, n_seq, i_seq), (l_mask, n_mask, i_mask)
        t_nat = [s.shape[1] for s in seqs]
        t_max = max(t_nat)
        mesh = role_mesh("route")
        if mesh is None:
            streams, inputs, gen = DIRECTIONAL_STREAMS, seqs, generator
        else:  # this rank's streams, gathered over the model group below
            streams = DIRECTIONAL_STREAMS[stream_slice(len(DIRECTIONAL_STREAMS), mesh)]
            inputs = tuple(copy_to_model_group(s) for s in seqs)
            gen = slice_generator(generator, mesh.model_index)
        q, kv, q_ext, kv_ext = _streams(inputs, streams, t_max)
        bias = _native_causal_bias(streams, t_nat, t_max, self.attn_mask).to(l_seq.device)
        h = self.directional(q, kv, kv, q_ext, kv_ext, generator=gen, attn_bias=bias)
        if mesh is not None:
            h = gather_streams(h)
        # the data masks, padded to t_max, decide the pooled step only
        pmask = [_pad_time(s, m.float(), t_max)[1] for s, m in zip(seqs, masks)]
        routes = {"L": l_pool, "N": n_pool, "I": i_pool}
        for g, name in enumerate(DIRECTIONAL_NAMES):
            routes[name] = _last_valid(h[g], pmask[DIRECTIONAL_STREAMS[g][0]])
        routes["LNI"] = self.LNI(l_seq, l_mask, n_seq, n_mask, i_seq, i_mask, generator=generator)
        return routes
