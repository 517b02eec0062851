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
thresholds, and ``serve.Predictor`` loads any of them. Under
``train.ckpt_backend=orbax_async`` the loop saves in the background
(``save_checkpoint(..., background=True)``): the tensors are copied to host
memory, one writer thread writes the directory, and ``wait_for_saves``
blocks until every write has landed (the loop calls it at its end).
``resolve``, which every reader calls first, waits for a write in flight
to the checkpoint it resolves, and for no other. A write that failed
re-raises from ``wait_for_saves`` and from the next save. A checkpoint
written before train states existed serves, but cannot resume or
warm-start a run (``restore_train_state`` raises).

The JAX package's checkpoints load too. ``resolve(dir, name)`` finds the
format on disk, as the JAX ``restore_checkpoint`` does:

- ``<dir>/<name>/`` is the port's directory;
- ``<dir>/<name>.msgpack`` with ``<dir>/<name>.meta.json`` is the JAX
  package's: its flax-msgpack train state is read by
  ``utils/flax_msgpack.py`` (no JAX needed) and mapped by ``bridge.py``; the
  config, step, temperature and thresholds come from the meta;
- ``<dir>/<name>.orbax/`` with ``<dir>/<name>.meta.json`` is the JAX
  package's orbax checkpoint: ``utils/orbax_reader.py`` reads it (numpy and
  pyarrow, no orbax or JAX) into the tree ``read_msgpack`` gives, and the
  rest is as for msgpack; a directory without its ``manifest.ocdbt`` raises
  ``FileNotFoundError``;
- anything else raises ``FileNotFoundError``.

Every reader takes ``(dir, name)``, or, with no name, the path
``<dir>/<name>`` itself. A JAX checkpoint serves its EMA weights where its
state has them (the weights JAX's ``Predictor`` serves) and its route-loss
EMA; it resumes with its step, count, moments, EMA and route-loss EMA, and,
having no loop schedule, starts the schedule afresh at its step, as the JAX
loop does on every resume.

Given the model's own state_dict, ``load_weights`` converts the BERT layers
between the layered (``layer_i.*``) and pipeline-parallel (``pp_layers.*``,
``parallel/pp.py``) layouts wherever the checkpoint and the model disagree,
as the JAX package's ``ckpt._convert_bert_layouts`` does on restore: a
layered checkpoint serves from a pipeline-layout config, and the reverse;
``restore_train_state`` converts a train state the same way.
"""
from __future__ import annotations

import copy
import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

from multimodalrouting_tpu_torch.configs import Config, from_dict, to_dict
from multimodalrouting_tpu_torch.utils.flax_msgpack import read_msgpack
from multimodalrouting_tpu_torch.utils.orbax_reader import MANIFEST, read_orbax

TRAIN_STATE = "train_state.pt"
PORT, JAX, ORBAX = "port", "jax", "orbax"

_WRITER: Optional[ThreadPoolExecutor] = None  # the one background writer (train.ckpt_backend=orbax_async)
_IN_FLIGHT: Dict[str, Future] = {}  # checkpoint directory -> its background write
_LOCK = threading.Lock()  # guards _IN_FLIGHT: readers may resolve from several threads


def host_copy(tree):
    """`tree` with every tensor copied to host memory (a tensor already on
    the host is copied too): what a background write may read while later
    steps change the state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return copy.deepcopy(tree)


def _raise_failed_writes() -> None:
    """Re-raise the error of a background write that has ended in one."""
    with _LOCK:
        ended = [_IN_FLIGHT.pop(key) for key, fut in list(_IN_FLIGHT.items()) if fut.done()]
    for fut in ended:
        fut.result()


def wait_for_saves() -> None:
    """Block until every background write has landed (the JAX package's
    ``ckpt.wait_for_saves``), then re-raise the first that failed."""
    with _LOCK:
        futures = list(_IN_FLIGHT.values())
        _IN_FLIGHT.clear()
    error = None
    for fut in futures:
        try:
            fut.result()
        except BaseException as e:  # every write is waited for before the first error surfaces
            error = error or e
    if error is not None:
        raise error


def _write(ckpt_dir, state_dict, cfg, temperature, thresholds, train_state) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    meta = {
        "step": 0 if train_state is None else int(train_state["step"]),
        "temperature": float(temperature),
        "thresholds": thresholds,
    }
    rle = None if train_state is None else train_state.get("route_loss_ema")
    if rle is not None:
        meta["route_loss_ema"] = [float(v) for v in rle]
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(ckpt_dir, "weights.pt"))
    if train_state is not None:
        torch.save(train_state, os.path.join(ckpt_dir, TRAIN_STATE))


def save_checkpoint(
    ckpt_dir: str,
    state_dict: Dict[str, torch.Tensor],
    cfg: Config,
    *,
    temperature: float = 1.0,
    thresholds: Optional[Sequence[float]] = None,
    train_state: Optional[Dict[str, Any]] = None,
    background: bool = False,
    on_written: Optional[Callable[[str, float], None]] = None,
) -> str:
    """Write the checkpoint directory; `train_state` (``train_state_dict``'s
    form) goes to ``train_state.pt``. A write still in flight to the same
    directory lands first, and a background write that failed re-raises
    here. With `background`, the tensors are copied to host memory
    (``host_copy``) and one background thread writes them: this returns
    once the copy is made. ``on_written(dir, seconds)`` runs when the write
    has landed (in that thread, for a background write)."""
    key = os.path.abspath(ckpt_dir)
    _raise_failed_writes()
    with _LOCK:
        earlier = _IN_FLIGHT.pop(key, None)
    if earlier is not None:
        earlier.result()
    thresholds = None if thresholds is None else [float(t) for t in thresholds]
    if background:
        state_dict, train_state = host_copy(state_dict), host_copy(train_state)

    def write() -> str:
        t0 = time.perf_counter()
        _write(ckpt_dir, state_dict, cfg, temperature, thresholds, train_state)
        if on_written is not None:
            on_written(ckpt_dir, time.perf_counter() - t0)
        return ckpt_dir

    if not background:
        return write()
    global _WRITER
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
    with _LOCK:
        _IN_FLIGHT[key] = _WRITER.submit(write)
    return ckpt_dir


def resolve(ckpt_dir: str, name: Optional[str] = None) -> Tuple[str, str]:
    """(format, path) of checkpoint `name` in `ckpt_dir` (without a name,
    `ckpt_dir` is the path ``<dir>/<name>``): (PORT, the directory), (JAX,
    the ``.msgpack`` file) or (ORBAX, the ``.orbax`` directory)."""
    if name is None:
        ckpt_dir, name = os.path.split(os.path.normpath(ckpt_dir))
    base = os.path.join(ckpt_dir, name)
    with _LOCK:  # every reader resolves first: a background write of this checkpoint may be in flight
        in_flight = _IN_FLIGHT.get(os.path.abspath(base))
    if in_flight is not None:
        in_flight.result()  # its error raises here too, and again from wait_for_saves or the next save
    if os.path.isdir(base):
        return PORT, base
    if os.path.isfile(base + ".msgpack"):
        if not os.path.isfile(base + ".meta.json"):
            raise FileNotFoundError(f"{base}.msgpack has no {name}.meta.json beside it (the config is there)")
        return JAX, base + ".msgpack"
    if os.path.isdir(base + ".orbax"):
        if not os.path.isfile(os.path.join(base + ".orbax", MANIFEST)):
            raise FileNotFoundError(f"{base}.orbax holds no {MANIFEST}: not a finished orbax checkpoint")
        if not os.path.isfile(base + ".meta.json"):
            raise FileNotFoundError(f"{base}.orbax has no {name}.meta.json beside it (the config is there)")
        return ORBAX, base + ".orbax"
    raise FileNotFoundError(f"no checkpoint {name!r} (a port directory, .msgpack or .orbax) in {ckpt_dir}")


def load_meta(ckpt_dir: str, name: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint's meta: step, temperature, thresholds (and, in the
    port's, the route-loss EMA; in the JAX package's, the config)."""
    fmt, path = resolve(ckpt_dir, name)
    meta = os.path.join(path, "meta.json") if fmt == PORT else os.path.splitext(path)[0] + ".meta.json"
    with open(meta) as f:
        return json.load(f)


def load_config(ckpt_dir: str, name: Optional[str] = None) -> Config:
    fmt, path = resolve(ckpt_dir, name)
    if fmt != PORT:
        return from_dict(load_meta(ckpt_dir, name)["config"])
    with open(os.path.join(path, "config.json")) as f:
        return from_dict(json.load(f))


def read_jax_state(fmt: str, path: str) -> Dict[str, Any]:
    """The JAX package's train state at `path` as nested dicts of arrays:
    its flax-msgpack file (JAX) or its orbax directory (ORBAX)."""
    return read_msgpack(path) if fmt == JAX else read_orbax(path)


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


def _has_pp(tree: Mapping[str, Any]) -> bool:
    return any(k == "pp_layers" or (isinstance(v, Mapping) and _has_pp(v)) for k, v in tree.items())


def _in_jax_layout(params: Mapping[str, Any], like: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """The model's state_dict `like` in the BERT layout the JAX `params`
    tree holds (the keys, shapes and dtypes ``bridge.py`` maps onto)."""
    from multimodalrouting_tpu_torch.parallel.pp import from_pp_layout, to_pp_layout

    if _has_pp(params) == any(k.endswith(_PP_KEY) for k in like):
        return like
    out = dict(like)
    for key in sorted(like):
        if key.endswith(_LAYERED_KEY):
            out = to_pp_layout(out, key[: -len(_LAYERED_KEY)])
        elif key.endswith(_PP_KEY):
            out = from_pp_layout(out, key[: -len(_PP_KEY)])
    return out


def load_serving(
    ckpt_dir: str, name: Optional[str] = None, *, like: Optional[Iterable[str]] = None, device="cpu",
) -> Tuple[Dict[str, torch.Tensor], Optional[List[float]]]:
    """(the serving weights, the route-loss EMA or None). The weights are the
    checkpoint's state_dict, in the BERT layout of `like` (the model's
    state_dict or its keys) where given. A JAX checkpoint needs `like` (the
    model's state_dict) and serves its EMA weights where its state has them."""
    from multimodalrouting_tpu_torch.bridge import state_dict_from_jax

    fmt, path = resolve(ckpt_dir, name)
    if fmt == PORT:
        weights = torch.load(os.path.join(path, "weights.pt"), map_location=device, weights_only=True)
        rle = load_meta(path).get("route_loss_ema")
    else:
        if not isinstance(like, Mapping):
            raise ValueError("a JAX checkpoint maps onto a model's parameters: pass like=model.state_dict()")
        tree = read_jax_state(fmt, path)
        weights = state_dict_from_jax(tree, _in_jax_layout(tree["params"], like))
        weights = {k: v.to(device) for k, v in weights.items()}
        rle = tree.get("route_loss_ema")
        rle = None if rle is None else [float(v) for v in rle]
    return (weights if like is None else convert_bert_layout(weights, like)), rle


def load_weights(ckpt_dir: str, name: Optional[str] = None, device="cpu",
                 like: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """The checkpoint's serving state_dict (``load_serving``)."""
    return load_serving(ckpt_dir, name, like=like, device=device)[0]


def restore_train_state(ckpt_dir: str, state, *, name: Optional[str] = None, params_only: bool = False):
    """Restore the train state of checkpoint `name` in `ckpt_dir` (the port's
    or the JAX package's) into `state` (a fresh ``TrainState`` of the run's
    model), with the JAX package's ``restore_checkpoint`` semantics: a full
    restore takes step, count, weights, moments and EMA; ``params_only`` the
    weights, buffers and EMA (stage chaining). Tensors are cast to the
    state's dtypes, and the BERT layout is converted where the checkpoint
    and the model disagree, which a full restore refuses (Adam's moments are
    keyed by the layout)."""
    from multimodalrouting_tpu_torch.bridge import train_state_dict_from_jax
    from multimodalrouting_tpu_torch.train.state import load_train_state_dict

    fmt, path = resolve(ckpt_dir, name)
    target = state.model.state_dict()
    if fmt != PORT:
        tree = read_jax_state(fmt, path)
        # a warm start leaves out the checkpoint's weights that the model
        # lacks, as the JAX restore_checkpoint's from_state_dict does
        saved = train_state_dict_from_jax(tree, _in_jax_layout(tree["params"], target), strict=not params_only)
    else:
        ts = os.path.join(path, TRAIN_STATE)
        if not os.path.exists(ts):
            raise FileNotFoundError(
                f"{path} holds no {TRAIN_STATE}: it is a serving checkpoint (its weights.pt holds the EMA, "
                "not the trained parameters and optimizer state), so no run can resume or warm-start from it"
            )
        saved = torch.load(ts, map_location="cpu", weights_only=True)
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
