"""MULTRouter — the 10-route directional cross-attention builder (counterpart
of multimodalrouting_tpu/models/mult.py).

Per-modality projections (1x1 conv == bias-free Dense), the three modality
sequences padded to one T_max, 3 self streams as one stacked program and 6
directional cross streams (L<-N, L<-I, N<-L, N<-I, I<-L, I<-N) as another,
masked pooling, pair merges into LN/LI/NI and the trimodal final_lni. In
training (a ``generator`` passed) embed_dropout also runs on the three
inputs before their projections, as in the JAX package.

Under the 'model' axis's ``route`` role (``train.route_parallel``,
``parallel/ep.py``) this rank holds and runs its slice of the six cross
streams: the replicated sequences enter through ``copy_to_model_group``,
the stream-local dropout draws from the rank's ``slice_generator``, and
``gather_streams`` assembles the six outputs before the pooling.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.models.transformer import StackedMulTEncoder
from multimodalrouting_tpu_torch.ops.masked import masked_last, masked_mean
from multimodalrouting_tpu_torch.parallel.mesh import (
    copy_to_model_group,
    gather_streams,
    role_mesh,
    slice_generator,
    stream_slice,
)

#: (query modality, kv modality) of the six cross streams, route order
#: LN, LI, NL, NI, IL, IN (L=0, N=1, I=2)
CROSS_STREAMS: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
CROSS_NAMES = ("LN", "LI", "NL", "NI", "IL", "IN")


def _pad_time(seq: torch.Tensor, mask: torch.Tensor, t_max: int):
    pad = t_max - seq.shape[1]
    if pad == 0:
        return seq, mask
    return F.pad(seq, (0, 0, 0, pad)), F.pad(mask, (0, pad))


class MULTRouter(nn.Module):
    def __init__(self, d_in_l: int, d_in_n: int, d_in_i: int, d: int = 256, num_heads: int = 8,
                 layers: int = 4, self_layers: int = 2, attn_mask: bool = False, pool: str = "mean",
                 positions: str = "sinusoidal", dtype=torch.float32, attn_dropout: float = 0.0,
                 relu_dropout: float = 0.0, res_dropout: float = 0.0, embed_dropout: float = 0.0):
        super().__init__()
        self.pool, self.dtype, self.embed_dropout = pool, dtype, embed_dropout
        self.proj_l = Dense(d_in_l, d, bias=False, dtype=dtype)
        self.proj_n = Dense(d_in_n, d, bias=False, dtype=dtype)
        self.proj_i = Dense(d_in_i, d, bias=False, dtype=dtype)
        common = dict(
            d=d, num_heads=num_heads, causal=attn_mask, positions=positions, dtype=dtype,
            attn_dropout=attn_dropout, relu_dropout=relu_dropout, res_dropout=res_dropout,
            embed_dropout=embed_dropout,
        )
        self.self_streams = StackedMulTEncoder(3, layers=self_layers, **common)
        self.cross_streams = StackedMulTEncoder(len(CROSS_STREAMS), layers=layers, **common)
        self.proj_pair_ln = Dense(2 * d, d, dtype=dtype)
        self.proj_pair_li = Dense(2 * d, d, dtype=dtype)
        self.proj_pair_ni = Dense(2 * d, d, dtype=dtype)
        self.final_lni = Dense(3 * d, d, dtype=dtype)

    def forward(
        self, x_l, x_n, x_i,
        m_l: Optional[torch.Tensor] = None, m_n: Optional[torch.Tensor] = None,
        m_i: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        b = x_l.shape[0]
        masks = [
            torch.ones((b, x.shape[1]), dtype=torch.float32, device=x.device) if m is None else m.float()
            for x, m in ((x_l, m_l), (x_n, m_n), (x_i, m_i))
        ]
        drop = lambda x: dropout(x.to(self.dtype), self.embed_dropout, generator)  # noqa: E731
        projected = (self.proj_l(drop(x_l)), self.proj_n(drop(x_n)), self.proj_i(drop(x_i)))
        t_max = max(p.shape[1] for p in projected)
        padded = [_pad_time(p, m, t_max) for p, m in zip(projected, masks)]
        seqs = torch.stack([p for p, _ in padded])  # [3,B,T,d]
        mods = torch.stack([m for _, m in padded])  # [3,B,T]
        pool_fn = masked_last if self.pool == "last" else masked_mean

        h_self = self.self_streams(seqs, None, None, mods, None, generator=generator)
        z_l, z_n, z_i = (pool_fn(h_self[i], mods[i]) for i in range(3))

        q_idx = torch.tensor([q for q, _ in CROSS_STREAMS], device=seqs.device)
        kv_idx = torch.tensor([kv for _, kv in CROSS_STREAMS], device=seqs.device)
        q_masks, kv_masks = mods[q_idx], mods[kv_idx]
        mesh = role_mesh("route")
        if mesh is None:
            kv_seqs = seqs[kv_idx]
            h_cross = self.cross_streams(seqs[q_idx], kv_seqs, kv_seqs, q_masks, kv_masks, generator=generator)
        else:  # this rank's streams, gathered over the model group
            mine = stream_slice(len(CROSS_STREAMS), mesh)
            shared = copy_to_model_group(seqs)
            kv_seqs = shared[kv_idx[mine]]
            h_cross = gather_streams(self.cross_streams(
                shared[q_idx[mine]], kv_seqs, kv_seqs, q_masks[mine], kv_masks[mine],
                generator=slice_generator(generator, mesh.model_index)))
        pooled = {name: pool_fn(h_cross[g], q_masks[g]) for g, name in enumerate(CROSS_NAMES)}

        e_ln = self.proj_pair_ln(torch.cat([pooled["LN"], pooled["NL"]], dim=-1))
        e_li = self.proj_pair_li(torch.cat([pooled["LI"], pooled["IL"]], dim=-1))
        e_ni = self.proj_pair_ni(torch.cat([pooled["NI"], pooled["IN"]], dim=-1))
        z_lni = self.final_lni(torch.cat([e_ln, e_li, e_ni], dim=-1))
        return {
            "L": z_l, "N": z_n, "I": z_i,
            "LN": pooled["LN"], "LI": pooled["LI"], "NL": pooled["NL"],
            "NI": pooled["NI"], "IL": pooled["IL"], "IN": pooled["IN"],
            "LNI": z_lni,
        }
