"""Pretrained encoder weights on the train path (counterpart of
multimodalrouting_tpu/pretrained.py).

The reference starts its note encoder from ``AutoModel.from_pretrained``
(Bio_ClinicalBERT) and its image backbone from torchvision's ImageNet
weights. Both arrive here as torch state_dicts named on the config:

  encoder.bert_weights   — a torch.save()d HF BertModel state_dict, or an HF
                           repo / directory name that transformers resolves
  encoder.vision_weights — a torch.save()d state_dict of the torchvision
                           model named by encoder.vision_backbone

``apply_pretrained`` copies both into a freshly built model in place, each
tensor cast to the dtype the model holds it in and every shape checked
first; every other module keeps its random init. ``train/loop.py:train_model``
calls it only when it is given no state, before the train state (and so the
EMA) is taken: neither ``--resume`` nor ``--init-from`` re-applies it.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping

import torch
from torch import nn


def _load_state_dict(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            # pickles holding more than tensors (MedFuse checkpoints wrapping
            # argparse namespaces) need full unpickling: the same trust as the
            # reference's own torch.load of user checkpoints
            obj = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        if isinstance(obj, dict) and "state_dict" in obj and not any(hasattr(v, "shape") for v in obj.values()):
            obj = obj["state_dict"]  # a lightning / MedFuse wrapper
        return obj
    # not a file: an HF repo or local model directory name
    from transformers import AutoModel

    return AutoModel.from_pretrained(path).state_dict()


def copy_checked(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Copy `tensors` into `module`'s state_dict in place, each cast to the
    module's dtype for it. Every key must be filled, and every shape must
    match, before anything is written."""
    target = module.state_dict()
    missing = sorted(set(target) - set(tensors))
    extra = sorted(set(tensors) - set(target))
    if missing or extra:
        raise KeyError(f"pretrained leaves do not cover the module: missing {missing[:4]}, unknown {extra[:4]}")
    for key, value in tensors.items():
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(
                f"pretrained leaf {key} shape {tuple(value.shape)} != template {tuple(target[key].shape)} — "
                "check encoder dims match the checkpoint"
            )
    with torch.no_grad():
        for key, value in tensors.items():
            target[key].copy_(value.to(target[key].dtype))


def load_bert_weights(path_or_name: str, layers: int, bert: nn.Module) -> nn.Module:
    """Copy an HF BertModel state_dict into `bert` (a ``BertEncoder``, layered
    or in the pipeline layout) in place; -> `bert`."""
    from multimodalrouting_tpu_torch.ckpt import convert_bert_layout
    from multimodalrouting_tpu_torch.models.clinbert import import_hf_bert_params

    imported = import_hf_bert_params(_load_state_dict(path_or_name), layers=layers)
    copy_checked(bert, convert_bert_layout(imported, bert.state_dict()))
    return bert


def apply_pretrained(cfg, model: nn.Module, log_fn: Callable[[str], None] = print) -> nn.Module:
    """Copy the configured pretrained weights into `model`'s note encoder and
    image backbone (BatchNorm running statistics included) in place; -> `model`."""
    from multimodalrouting_tpu_torch.models.cxr import import_torchvision_backbone_params

    e = cfg.encoder
    if e.bert_weights:
        load_bert_weights(e.bert_weights, e.bert_layers, model.encoders.bbert.bert)
        log_fn(f"[pretrained] note encoder <- {e.bert_weights}")
    if e.vision_weights:
        if e.vision_norm != "batch":
            raise ValueError(
                "encoder.vision_weights needs encoder.vision_norm=batch "
                "(torchvision checkpoints carry BatchNorm running stats)"
            )
        copy_checked(model.encoders.imgenc.backbone,
                     import_torchvision_backbone_params(_load_state_dict(e.vision_weights), e.vision_backbone))
        log_fn(f"[pretrained] vision backbone <- {e.vision_weights}")
    return model
