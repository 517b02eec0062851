"""JAX variables -> the port's state_dict.

The port names its modules as the JAX package's flax modules are named, so a
flax leaf path maps onto a state_dict key mechanically:

- a leaf whose dotted path is already a key is copied as it is: the stacked
  [G, ...] MulT stream parameters, the capsule weight ``w [N,A,M,D]``, the
  projector's stacked kernel, BEHRT's ``pos`` / ``cls_token``, biases;
- Dense ``kernel [in, out]`` becomes Linear ``weight [out, in]``;
- Conv ``kernel`` HWIO becomes ``weight`` OIHW;
- Embed ``embedding`` and LayerNorm / BatchNorm ``scale`` become ``weight``;
- BatchNorm ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` /
  ``running_var``.

Every key of the target state_dict must be filled exactly once, with its
shape; values are cast to the target's dtype (the frozen BERT body is held
in bf16 under bf16 compute, as the JAX train state holds it). When the JAX
state carries ``ema_params``, those are the serving weights.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
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
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(ref.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model keys with no JAX leaf: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX variables into `model` in place; returns it."""
    model.load_state_dict(state_dict_from_jax(variables, model))
    return model
