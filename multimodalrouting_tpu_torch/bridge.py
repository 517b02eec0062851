"""JAX variables -> the port's state_dict.

The port names its modules as the JAX package's flax modules are named, so a
flax leaf path maps onto a state_dict key mechanically:

- a leaf whose dotted path is already a key is copied as it is: the stacked
  [G, ...] MulT stream parameters, the capsule weight ``w [N,A,M,D]``, the
  projector's stacked kernel, BEHRT's ``pos`` / ``cls_token``, biases;
- Dense ``kernel [in, out]`` becomes Linear ``weight [out, in]``;
- Conv ``kernel`` HWIO becomes ``weight`` OIHW;
- Embed ``embedding`` and LayerNorm / BatchNorm ``scale`` become ``weight``;
- a scalar (a fusion's ``res_scale``) stays 0-d;
- BatchNorm ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` /
  ``running_var``.

Every key of the target state_dict must be filled exactly once, with its
shape; values are cast to the target's dtype (the frozen BERT body is held
in bf16 under bf16 compute, as the JAX train state holds it). When the JAX
state carries ``ema_params``, those are the serving weights
(``state_dict_from_jax``).

``train_state_from_jax`` carries a whole JAX ``TrainState`` for resuming
training: ``params`` into the model, ``batch_stats`` into its buffers,
``ema_params`` into the EMA, ``route_loss_ema`` (the loss-based sMRO gate's)
into the port's, and the Adam moments and count out of the optax state
(found by their ``mu`` / ``nu`` / ``count`` fields, leaves frozen by the
BERT rule or the curriculum stage masked out), all as numpy.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _array_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _array_leaves(v, prefix + (str(k),))
        elif hasattr(v, "shape"):
            yield prefix + (str(k),), np.asarray(v)


def _param_key(path: Tuple[str, ...], value: np.ndarray, target: Mapping[str, torch.Tensor]):
    plain = ".".join(path)
    if plain in target:
        return plain, value
    module, leaf = path[:-1], path[-1]
    key = ".".join(module + ("weight",))
    if leaf == "kernel" and value.ndim == 2:
        return key, value.T
    if leaf == "kernel" and value.ndim == 4:
        return key, value.transpose(3, 2, 0, 1)
    if leaf in ("scale", "embedding"):
        return key, value
    raise KeyError(f"no state_dict key for JAX parameter {'/'.join(path)}")


def state_dict_from_jax(variables: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Map JAX variables {"params" (or "ema_params"), "batch_stats"} as numpy
    trees onto `model`'s state_dict keys, shapes and dtypes."""
    target = model.state_dict()
    params = variables.get("ema_params") or variables["params"]
    pairs = [_param_key(path, value, target) for path, value in _leaves(params)]
    for path, value in _leaves(variables.get("batch_stats") or {}):
        pairs.append((".".join(path[:-1] + (_STATS[path[-1]],)), value))
    out: Dict[str, torch.Tensor] = {}
    for key, value in pairs:
        if key not in target:
            raise KeyError(f"JAX leaf maps to {key!r}, which the model does not have")
        if key in out:
            raise KeyError(f"two JAX leaves map to {key!r}")
        ref = target[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {value.shape} vs port shape {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value).reshape(value.shape)).to(ref.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model keys with no JAX leaf: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out


def _converted(tree: Mapping[str, Any], target: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A parameter tree (EMA or an Adam moment) by state_dict key, fp32 on
    the target's device; leaves that are not arrays (optax's masked frozen
    leaves) are skipped."""
    out = {}
    for path, value in _array_leaves(tree):
        key, value = _param_key(path, value, target)
        ref = target[key]
        value = np.ascontiguousarray(value).reshape(value.shape)
        out[key] = torch.from_numpy(value).to(device=ref.device, dtype=torch.float32)
    return out


def _adam_state(opt_state) -> Optional[Any]:
    """The optax ScaleByAdamState inside a (multi_transform, chain, masked)
    state tree, or None."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu") and hasattr(opt_state, "count"):
        return opt_state
    children = opt_state.values() if isinstance(opt_state, Mapping) else (
        opt_state if isinstance(opt_state, (tuple, list)) else ()
    )
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(cfg, model: torch.nn.Module, jax_state: Mapping[str, Any], stage: str = ""):
    """A port TrainState at curriculum `stage` from a JAX TrainState's fields
    as numpy trees: {"params", "batch_stats", "ema_params", "opt_state",
    "step", "route_loss_ema"}."""
    from multimodalrouting_tpu_torch.train.state import create_train_state

    model.load_state_dict(
        state_dict_from_jax({"params": jax_state["params"], "batch_stats": jax_state.get("batch_stats")}, model)
    )
    rle = jax_state.get("route_loss_ema")
    state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=0 if rle is None else len(rle))
    if rle is not None:
        state.route_loss_ema.copy_(torch.from_numpy(np.array(rle, dtype=np.float32)))
    target = dict(model.named_parameters())
    adam = _adam_state(jax_state["opt_state"])
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        moments = _converted(tree, target)
        if sorted(moments) != sorted(state.names):
            raise KeyError(f"JAX Adam {name} covers {len(moments)} leaves, the port trains {len(state.names)}")
        getattr(state, name).update(moments)
    state.count = int(np.asarray(adam.count))
    state.step = int(np.asarray(jax_state.get("step", state.count)))
    if state.ema is not None and jax_state.get("ema_params") is not None:
        ema = _converted(jax_state["ema_params"], target)
        state.ema.update({n: ema[n] for n in state.names})
    return state


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX variables into `model` in place; returns it."""
    model.load_state_dict(state_dict_from_jax(variables, model))
    return model
