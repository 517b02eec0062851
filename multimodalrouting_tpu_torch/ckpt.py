"""The port's checkpoint: a directory holding

- ``config.json`` — ``configs.to_dict(cfg)``;
- ``meta.json`` — ``step``, ``temperature`` and ``thresholds``, the keys the
  JAX package's meta carries, and ``route_loss_ema`` where the train state
  keeps one (the loss-based sMRO gate's [7] route losses, which serving
  needs beside the weights; the JAX package keeps them in its state file);
- ``weights.pt`` — the model's state_dict (serving weights: the EMA ones
  where the run kept an EMA);
- ``train_state.pt`` — where a train state was given: the train state as
  ``train/state.py:train_state_dict`` gives it (step, Adam's count, the raw
  state_dict, moments, EMA, the route-loss EMA, the loop's schedule). A
  train state written without a route-loss EMA restores into one that
  keeps it, which then stays zero.

``train/loop.py:train_model`` writes one such directory, train state
included, per checkpoint name under its ``ckpt_dir`` (``best``, ``best_f1``,
``last``, ``final``); ``final`` carries the fitted temperature and
thresholds, and ``serve.Predictor`` loads any of them. The JAX package's
``<dir>/<name>.msgpack`` is the port's ``<dir>/<name>/``. A checkpoint
written before train states existed serves, but cannot resume or
warm-start a run (``restore_train_state`` raises).

Given the model's own state_dict, ``load_weights`` converts the BERT layers
between the layered (``layer_i.*``) and pipeline-parallel (``pp_layers.*``,
``parallel/pp.py``) layouts wherever the checkpoint and the model disagree,
as the JAX package's ``ckpt._convert_bert_layouts`` does on restore: a
layered checkpoint serves from a pipeline-layout config, and the reverse;
``restore_train_state`` converts a train state the same way.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

from multimodalrouting_tpu_torch.configs import Config, from_dict, to_dict

TRAIN_STATE = "train_state.pt"


def save_checkpoint(
    ckpt_dir: str,
    state_dict: Dict[str, torch.Tensor],
    cfg: Config,
    *,
    temperature: float = 1.0,
    thresholds: Optional[Sequence[float]] = None,
    train_state: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the checkpoint directory; `train_state` (``train_state_dict``'s
    form) goes to ``train_state.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    meta = {
        "step": 0 if train_state is None else int(train_state["step"]),
        "temperature": float(temperature),
        "thresholds": None if thresholds is None else [float(t) for t in thresholds],
    }
    rle = None if train_state is None else train_state.get("route_loss_ema")
    if rle is not None:
        meta["route_loss_ema"] = [float(v) for v in rle]
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(ckpt_dir, "weights.pt"))
    if train_state is not None:
        torch.save(train_state, os.path.join(ckpt_dir, TRAIN_STATE))
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


def restore_train_state(ckpt_dir: str, state, *, params_only: bool = False):
    """Restore the train state in `ckpt_dir` into `state` (a fresh
    ``TrainState`` of the run's model), with the JAX package's
    ``restore_checkpoint`` semantics: a full restore takes step, count,
    weights, moments and EMA; ``params_only`` the weights, buffers and EMA
    (stage chaining). Tensors are cast to the state's dtypes, and the BERT
    layout is converted where the checkpoint and the model disagree, which a
    full restore refuses (Adam's moments are keyed by the layout)."""
    from multimodalrouting_tpu_torch.train.state import load_train_state_dict

    path = os.path.join(ckpt_dir, TRAIN_STATE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{ckpt_dir} holds no {TRAIN_STATE}: it is a serving checkpoint (its weights.pt holds the EMA, "
            "not the trained parameters and optimizer state), so no run can resume or warm-start from it"
        )
    saved = torch.load(path, map_location="cpu", weights_only=True)
    target = state.model.state_dict()
    model_sd = convert_bert_layout(saved["model"], target)
    if set(model_sd) != set(saved["model"]) and not params_only:
        raise ValueError(
            "checkpoint and run use different BERT param layouts "
            "(layered vs pipeline-parallel pp_layers); full --resume cannot "
            "carry the optimizer state across layouts — warm-start with "
            "--init-from instead"
        )
    saved["model"] = model_sd
    if saved.get("ema") is not None:
        saved["ema"] = convert_bert_layout(saved["ema"], target)
    return load_train_state_dict(state, saved, params_only=params_only)
