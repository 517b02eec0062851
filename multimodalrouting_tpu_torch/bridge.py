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

The same holds for DenseNet-121 (``backbone.block1_layer0.bn1``,
``backbone.transition1_conv``, ``backbone.bn_final``) and the unimodal
trainers' models (``behrt``, ``head_{task}``, ``ln`` / ``fc1`` / ``fc2``; the
OMOP and CT wrappers' ``omop.proc_emb`` and ``ct.backbone``, as the JAX
trainers' adapters name them).

Every key of the target state_dict must be filled exactly once, with its
shape; values are cast to the target's dtype (the frozen BERT body is held
in bf16 under bf16 compute, as the JAX train state holds it). When the JAX
state carries ``ema_params``, those are the serving weights
(``state_dict_from_jax``).

``train_state_dict_from_jax`` carries a whole JAX ``TrainState`` into the
port's on-disk train state, for resuming training (``train_state_from_jax``
loads it into a model): ``params`` into the model, ``batch_stats`` into its
buffers, ``ema_params`` into the EMA, ``route_loss_ema`` (the loss-based
sMRO gate's) into the port's, and the Adam moments and count out of the
optax state (found by their ``mu`` / ``nu`` / ``count`` fields, leaves
frozen by the BERT rule or the curriculum stage masked out). The trees may
be the JAX state in memory as numpy, or a checkpoint as
``utils/flax_msgpack.py`` restores it (``ckpt.py``).

``rank_state_dict_from_jax`` adds the mesh's slicing step: JAX variables,
mapped onto the whole model's state_dict, then this rank's slice of each
parameter that a role of the 'model' axis shards
(``parallel/mesh.py:local_state_dict``), as a tensor- or route-parallel
rank holds it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_ADAM_FIELDS = ("mu", "nu", "count")


def _tensor(value) -> torch.Tensor:
    """A leaf as a CPU tensor, sharing its memory where it can: a torch
    tensor as it is, a numpy array (``bfloat16`` ones through their uint16
    bits, as numpy has no bf16 of its own) or a scalar."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.asarray(value)
    a = np.ascontiguousarray(a).reshape(a.shape)  # ascontiguousarray makes 0-d leaves 1-d
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every array leaf; leaves that are not arrays
    (optax's masked frozen leaves: ``MaskedNode`` in memory, an empty dict in
    a restored checkpoint) are skipped."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        elif hasattr(v, "shape"):
            yield prefix + (str(k),), _tensor(v)


def _param_key(path: Tuple[str, ...], value, target: Mapping[str, torch.Tensor]):
    value = _tensor(value)
    plain = ".".join(path)
    if plain in target:
        return plain, value
    module, leaf = path[:-1], path[-1]
    key = ".".join(module + ("weight",))
    if leaf == "kernel" and value.dim() == 2:
        return key, value.t()
    if leaf == "kernel" and value.dim() == 4:
        return key, value.permute(3, 2, 0, 1)
    if leaf in ("scale", "embedding"):
        return key, value
    raise KeyError(f"no state_dict key for JAX parameter {'/'.join(path)}")


def _keyed(tree: Mapping[str, Any], target: Mapping[str, torch.Tensor], strict: bool):
    """(state_dict key, tensor) of every leaf of `tree`; unless `strict`,
    the leaves that map to no key of `target` are left out."""
    for path, value in _leaves(tree):
        try:
            key, value = _param_key(path, value, target)
        except KeyError:
            if strict:
                raise
            continue
        if strict or key in target:
            yield key, value


Target = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _target(model: Target) -> Mapping[str, torch.Tensor]:
    return model.state_dict() if isinstance(model, torch.nn.Module) else model


def state_dict_from_jax(variables: Mapping[str, Any], model: Target, *,
                        strict: bool = True) -> Dict[str, torch.Tensor]:
    """Map JAX variables {"params" (or "ema_params"), "batch_stats"} as numpy
    or torch trees onto `model`'s state_dict (or the state_dict given)
    keys, shapes and dtypes, as CPU tensors. With ``strict=False`` the
    parameters the model lacks are left out, as flax's ``from_state_dict``
    leaves out a checkpoint's weights that its template lacks (a loss-based
    stage warm-started from a learned gate's checkpoint); a model key with
    no JAX leaf raises either way."""
    target = _target(model)
    params = variables.get("ema_params") or variables["params"]
    pairs = list(_keyed(params, target, strict))
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
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} vs port shape {tuple(ref.shape)}")
        out[key] = value.contiguous().to(ref.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model keys with no JAX leaf: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out


def rank_state_dict_from_jax(variables: Mapping[str, Any], model: Target, mesh, spec_for_name) -> Dict[str, torch.Tensor]:
    """``state_dict_from_jax`` onto the whole `model` (or its state_dict),
    then this rank's slices of the keys `spec_for_name` shards over `mesh`'s
    model group (``parallel/tp.py:tp_spec_for_name``,
    ``parallel/ep.py:ep_spec_for_name``)."""
    from multimodalrouting_tpu_torch.parallel.mesh import local_state_dict

    return local_state_dict(state_dict_from_jax(variables, model), mesh, spec_for_name)


def _converted(tree: Mapping[str, Any], target: Mapping[str, torch.Tensor],
               strict: bool = True) -> Dict[str, torch.Tensor]:
    """A parameter tree (EMA or an Adam moment) by state_dict key, in its
    own dtype (a train state's load casts); masked frozen leaves skipped."""
    return dict(_keyed(tree, target, strict))


def _adam_state(opt_state) -> Optional[Tuple[Any, Any, Any]]:
    """(mu, nu, count) of the optax ScaleByAdamState inside a
    (multi_transform, chain, masked) state tree, or None. In memory the
    state is a NamedTuple; in a restored checkpoint NamedTuples are dicts
    keyed by field name and tuples dicts keyed "0", "1", ...."""
    if isinstance(opt_state, Mapping):
        if all(f in opt_state for f in _ADAM_FIELDS):
            return tuple(opt_state[f] for f in _ADAM_FIELDS)
        children = opt_state.values()
    elif all(hasattr(opt_state, f) for f in _ADAM_FIELDS):
        return tuple(getattr(opt_state, f) for f in _ADAM_FIELDS)
    else:
        children = opt_state if isinstance(opt_state, (tuple, list)) else ()
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def train_state_dict_from_jax(jax_state: Mapping[str, Any], model: Target, *,
                              strict: bool = True) -> Dict[str, Any]:
    """A JAX TrainState's fields as numpy or torch trees ({"params",
    "batch_stats", "ema_params", "opt_state", "step", "route_loss_ema"}: in
    memory, or as a checkpoint restores them) -> the port's on-disk train
    state (``train/state.py:train_state_dict``'s form) over `model`'s
    state_dict keys. A JAX state carries no loop schedule: a resume from it
    starts the schedule afresh at its step, as the JAX loop does.
    ``strict=False`` leaves out the parameters the model lacks
    (``state_dict_from_jax``), in every tree."""
    target = _target(model)
    adam = _adam_state(jax_state["opt_state"])
    if adam is None:
        raise KeyError("the JAX optimizer state holds no Adam moments (mu, nu, count)")
    mu, nu, count = adam
    ema, rle = jax_state.get("ema_params"), jax_state.get("route_loss_ema")
    step = jax_state.get("step")
    return {
        "step": int(np.asarray(count if step is None else step)),
        "count": int(np.asarray(count)),
        "model": state_dict_from_jax({"params": jax_state["params"], "batch_stats": jax_state.get("batch_stats")},
                                     target, strict=strict),
        "mu": _converted(mu, target, strict),
        "nu": _converted(nu, target, strict),
        "ema": None if ema is None else _converted(ema, target, strict),
        "route_loss_ema": None if rle is None else _tensor(rle).float(),
        "loop": {},
    }


def train_state_from_jax(cfg, model: torch.nn.Module, jax_state: Mapping[str, Any], stage: str = ""):
    """A port TrainState at curriculum `stage` from a JAX TrainState's fields
    (``train_state_dict_from_jax``), loaded into `model`."""
    from multimodalrouting_tpu_torch.train.state import create_train_state, load_train_state_dict

    saved = train_state_dict_from_jax(jax_state, model)
    rle = saved["route_loss_ema"]
    state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=0 if rle is None else len(rle))
    return load_train_state_dict(state, saved)


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX variables into `model` in place; returns it."""
    model.load_state_dict(state_dict_from_jax(variables, model))
    return model
