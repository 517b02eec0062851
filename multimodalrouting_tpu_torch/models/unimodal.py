"""The unimodal trainers' models (counterpart of
multimodalrouting_tpu/models/unimodal.py).

- ``WideBEHRTClassifier``: wide lab columns [B, n_bins * n_labs] reshaped to
  [B, n_bins, n_labs], a mean-pooled BEHRT, one ``head_{t}`` per task
  (01_BEHRT.py's mortality / PE / PH, 02_BEHRT.py's readmission);
- ``NoteEmbeddingClassifier``: an aggregated note embedding through
  LayerNorm, ``fc1``, exact GELU, dropout and ``fc2`` (01_BioClinicalBert.py).

Modules carry the flax names, so ``bridge.py`` maps JAX parameters onto them.
Dropout draws from an explicit generator in training, as elsewhere in the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.behrt import BEHRTLabEncoder
from multimodalrouting_tpu_torch.models.layers import Dense, dropout
from multimodalrouting_tpu_torch.ops.layernorm import LayerNorm


class WideBEHRTClassifier(nn.Module):
    def __init__(self, n_bins: int, n_labs: int, d: int = 128, n_layers: int = 2, n_heads: int = 8,
                 tasks: Sequence[str] = ("mortality", "pe", "ph"), dtype=torch.float32):
        super().__init__()
        self.n_bins, self.n_labs, self.tasks = n_bins, n_labs, tuple(tasks)
        self.behrt = BEHRTLabEncoder(n_feats=n_labs, d=d, seq_len=n_bins, n_layers=n_layers, n_heads=n_heads,
                                     pool="mean", dtype=dtype)
        for t in self.tasks:
            self.add_module(f"head_{t}", Dense(d, 1, dtype=dtype))

    def forward(self, x_wide: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = x_wide.reshape(x_wide.shape[0], self.n_bins, self.n_labs)
        _, _, pooled = self.behrt(x, generator=generator)
        return {t: getattr(self, f"head_{t}")(pooled)[:, 0] for t in self.tasks}


class NoteEmbeddingClassifier(nn.Module):
    """Aggregated note embedding [B, in] -> logits [B] (one class) or [B, C]."""

    def __init__(self, d_in: int, hidden: int = 256, num_classes: int = 1, p_drop: float = 0.2,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes, self.p_drop = num_classes, p_drop
        self.ln = LayerNorm(d_in, 1e-5, dtype)
        self.fc1 = Dense(d_in, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, num_classes, dtype=dtype)

    def forward(self, emb: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(self.fc1(self.ln(emb)), approximate="none")
        logits = self.fc2(dropout(h, self.p_drop, generator))
        return logits[:, 0] if self.num_classes == 1 else logits
