"""The baseline families (counterpart of
multimodalrouting_tpu/models/baselines.py):

- ``LateFusion``: the pooled zL, zN, zI concatenated -> an MLP head;
- ``TriMF``: three rich-feature pair fusions (LN, LI, NI), a softmax gate
  over the three streams from [zL|zN|zI], then a Dense head.

Both train under the ``fame`` loss family (multitask BCE plus the
fairness term), as the JAX CLI trains them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.models.full import ModelOutput, TriEncoder, collect_batch_stats, compute_dtype
from multimodalrouting_tpu_torch.models.fusions import MLPBlock, PairwiseFusion
from multimodalrouting_tpu_torch.models.layers import Dense
from multimodalrouting_tpu_torch.routes import ROUTES_7


class LateFusion(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        self.cfg, self.routes = cfg, ROUTES_7
        dtype = compute_dtype(cfg)
        self.encoders = TriEncoder(cfg, dtype)
        self.head = MLPBlock(3 * cfg.encoder.d, m.num_classes, hidden=[2 * m.d], p_drop=m.fusion_dropout,
                             dtype=dtype)

    def forward(self, batch: Batch, train: bool = False, generator: Optional[torch.Generator] = None,
                note_pack: int = 0) -> ModelOutput:
        gen = generator if train else None
        enc = self.encoders(batch, train, gen, note_pack)
        logits = self.head(torch.cat([enc.l_pool, enc.n_pool, enc.i_pool], dim=-1), gen)
        return ModelOutput(
            logits=logits.float(), pooled={"L": enc.l_pool, "N": enc.n_pool, "I": enc.i_pool},
            chexpert_logits=enc.chexpert_logits.float(), batch_stats=collect_batch_stats(self) if train else None,
        )


class TriMF(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        self.cfg, self.routes = cfg, ROUTES_7
        dtype = self.dtype = compute_dtype(cfg)
        self.encoders = TriEncoder(cfg, dtype)
        self.pair_ln, self.pair_li, self.pair_ni = (
            PairwiseFusion(m.d, "rich", m.fusion_dropout, dtype) for _ in range(3)
        )
        self.gate = Dense(3 * cfg.encoder.d, 3, dtype=dtype)
        self.head = Dense(m.d, m.num_classes, dtype=dtype)

    def forward(self, batch: Batch, train: bool = False, generator: Optional[torch.Generator] = None,
                note_pack: int = 0) -> ModelOutput:
        gen = generator if train else None
        enc = self.encoders(batch, train, gen, note_pack)
        zl, zn, zi = enc.l_pool, enc.n_pool, enc.i_pool
        h_ln, h_li, h_ni = self.pair_ln(zl, zn, gen), self.pair_li(zl, zi, gen), self.pair_ni(zn, zi, gen)
        gates = torch.softmax(self.gate(torch.cat([zl, zn, zi], dim=-1)).float(), dim=-1).to(self.dtype)
        fused = gates[:, 0:1] * h_ln + gates[:, 1:2] * h_li + gates[:, 2:3] * h_ni
        return ModelOutput(
            logits=self.head(fused).float(), gates=gates.float(), pooled={"L": zl, "N": zn, "I": zi},
            chexpert_logits=enc.chexpert_logits.float(), batch_stats=collect_batch_stats(self) if train else None,
        )


BASELINES = {"late_fusion": LateFusion, "trimf": TriMF}


def build_baseline(cfg: Config, name: str, **kwargs) -> nn.Module:
    """``models.full.build_model`` for a baseline `name` (same keywords)."""
    if name not in BASELINES:
        raise ValueError(f"Unknown baseline {name!r}")
    from multimodalrouting_tpu_torch.models.full import build_model

    return build_model(cfg, name, **kwargs)
