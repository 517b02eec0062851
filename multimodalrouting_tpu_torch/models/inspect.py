"""The INSPECT cohort's models (counterpart of
multimodalrouting_tpu/models/inspect.py).

- ``CTVolumeEncoder``: a CT volume [B, S, H, W, C] through a 2D ResNet per
  slice (the slice axis folded into the batch, so the whole volume is one
  convolution), a slice mean (masked, its count clipped at 1) and ``proj``
  (INSPECT/models/encoders.py:119-207);
- ``OMOPConceptModel``: procedure / measurement / drug concept embeddings
  (a [B, T] id sequence is mean-pooled), concatenated, a ReLU ``fuse``,
  dropout and the four task heads (INSPECT/BEHRT.py:62-90 CombinedModel).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.cxr import make_backbone
from multimodalrouting_tpu_torch.models.layers import Dense, Embed, dropout

INSPECT_TASKS = ("pe", "mort1m", "read1m", "ph12m")


class CTVolumeEncoder(nn.Module):
    """x [B, S, H, W, C] (NHWC slices), slice_mask [B, S] -> pooled [B, d]."""

    def __init__(self, d: int = 256, backbone: str = "resnet18", norm_kind: str = "group", in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.backbone = make_backbone(backbone, norm_kind, dtype, in_channels=in_channels)
        self.proj = Dense(self.backbone.out_channels, d, dtype=dtype)

    def forward(self, x: torch.Tensor, slice_mask: Optional[torch.Tensor] = None, train: bool = False):
        b, s, h, w, c = x.shape
        flat = x.reshape(b * s, h, w, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pooled, _ = self.backbone(flat, train)
        feats = pooled.reshape(b, s, -1)
        if slice_mask is not None:
            m = slice_mask.to(feats.dtype)[..., None]
            feats = (feats * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        else:
            feats = feats.mean(dim=1)
        return self.proj(feats)


class OMOPConceptModel(nn.Module):
    def __init__(self, num_proc_codes: int, num_meas_codes: int, num_drug_codes: int, hidden: int = 128,
                 p_drop: float = 0.1, tasks: Sequence[str] = INSPECT_TASKS, dtype=torch.float32):
        super().__init__()
        self.tasks, self.p_drop = tuple(tasks), p_drop
        self.proc_emb = Embed(num_proc_codes, hidden, dtype)
        self.meas_emb = Embed(num_meas_codes, hidden, dtype)
        self.drug_emb = Embed(num_drug_codes, hidden, dtype)
        self.fuse = Dense(3 * hidden, hidden, dtype=dtype)
        for t in self.tasks:
            self.add_module(f"head_{t}", Dense(hidden, 1, dtype=dtype))

    def forward(self, proc: torch.Tensor, meas: torch.Tensor, drug: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Concept ids [B] or [B, T] each -> {task: logits [B]}."""

        def emb(ids, table):
            e = table(ids)
            return e.mean(dim=1) if e.dim() == 3 else e

        h = torch.cat([emb(proc, self.proc_emb), emb(meas, self.meas_emb), emb(drug, self.drug_emb)], dim=-1)
        h = dropout(F.relu(self.fuse(h)), self.p_drop, generator)
        return {t: getattr(self, f"head_{t}")(h)[:, 0] for t in self.tasks}
