"""The port's checkpoint: a directory holding

- ``config.json`` — ``configs.to_dict(cfg)``;
- ``meta.json`` — ``temperature`` and ``thresholds``, the keys the JAX
  package's meta carries for serving;
- ``weights.pt`` — the model's state_dict (serving weights: the EMA ones
  where the run kept an EMA).

``train/loop.py:train_model`` writes one such directory per checkpoint name
under its ``ckpt_dir`` (``best``, ``best_f1``, ``last``, ``final``); ``final``
carries the fitted temperature and thresholds, and ``serve.Predictor`` loads
any of them.

Given the model's own state_dict, ``load_weights`` converts the BERT layers
between the layered (``layer_i.*``) and pipeline-parallel (``pp_layers.*``,
``parallel/pp.py``) layouts wherever the checkpoint and the model disagree,
as the JAX package's ``ckpt._convert_bert_layouts`` does on restore: a
layered checkpoint serves from a pipeline-layout config, and the reverse.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

from multimodalrouting_tpu_torch.configs import Config, from_dict, to_dict


def save_checkpoint(
    ckpt_dir: str,
    state_dict: Dict[str, torch.Tensor],
    cfg: Config,
    *,
    temperature: float = 1.0,
    thresholds: Optional[Sequence[float]] = None,
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    meta = {
        "temperature": float(temperature),
        "thresholds": None if thresholds is None else [float(t) for t in thresholds],
    }
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(ckpt_dir, "weights.pt"))
    return ckpt_dir


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return from_dict(json.load(f))


def load_meta(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        return json.load(f)


_PP_KEY = "pp_layers.q_kernel"
_LAYERED_KEY = "layer_0.attention.attn.q_proj.weight"


def convert_bert_layout(weights: Dict[str, torch.Tensor], target_keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """`weights` with every BERT encoder in the layout `target_keys` hold it
    in (layered or pipeline-parallel); the rest passes through."""
    from multimodalrouting_tpu_torch.parallel.pp import from_pp_layout, to_pp_layout

    target = set(target_keys)
    for key in sorted(target):
        prefix = key[: -len(_PP_KEY)]
        if key.endswith(_PP_KEY) and prefix + _LAYERED_KEY in weights:
            weights = to_pp_layout(weights, prefix)
    for key in sorted(weights):
        prefix = key[: -len(_PP_KEY)]
        if key.endswith(_PP_KEY) and prefix + _LAYERED_KEY in target:
            weights = from_pp_layout(weights, prefix)
    return weights


def load_weights(ckpt_dir: str, device="cpu", like: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """The checkpoint's state_dict; with `like` (the model's state_dict or its
    keys), in the model's BERT layout."""
    weights = torch.load(os.path.join(ckpt_dir, "weights.pt"), map_location=device, weights_only=True)
    return weights if like is None else convert_bert_layout(weights, like)
