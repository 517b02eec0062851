"""The train state: the model (parameters and BatchNorm statistics), Adam's
moments and count, and the EMA of the weights (counterpart of
multimodalrouting_tpu/train/state.py).

The optimizer is written on tensors to match the JAX package's optax chain
(state.py:114-127, applied per leaf in apply_gradients :187-259):

1. clip by the global norm (``train.grad_clip``) of the trainable leaves;
2. Adam: b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root, bias
   correction by the optimizer's own count;
3. add ``train.weight_decay * param``;
4. multiply by -lr, with ``lr_enc`` for leaves under ``encoders`` and
   ``lr_head`` for the rest.

Frozen leaves take no gradient, carry no moments and are skipped by the EMA
(decay ``train.ema_decay``): the BERT body unless ``encoder.finetune_text``,
and whatever the curriculum stage freezes (``leaf_trainable``). An update
mask, where the step gives one, multiplies the post-optimizer updates of
sliced leaves (the loss-based sMRO curriculum's frozen route heads), so
that decoupled weight decay cannot move the frozen slices. A non-finite gradient leaves the parameters, moments,
count, EMA and BatchNorm statistics as they were; ``step`` still advances.
Updates are in place: PyTorch parameters are mutable, where the JAX state is
rebuilt each step.

Under ZeRO-1 (``train.zero_sharded_opt`` on a mesh, ``parallel/zero.py``)
the state holds only this rank's row slices of the sharded leaves' moments
(``zero``): the finite guard and the clip norm reduce over the data group,
Adam and the decay update this rank's rows of each such parameter, and the
rows are all-gathered before the EMA, in the same ``torch._foreach_*`` order.

Under the 'model' axis's ``tensor``, ``route`` or ``pipeline`` role (``shards``,
``parallel/mesh.py:place_state``) the state holds this rank's slice of each
model-sharded parameter, of its moments and of its EMA: the global clip norm
counts each such leaf once (its slice's sum of squares summed over the model
group), the finite guard agrees over the whole world, and ZeRO-1 composes on
the local slices. ``train_state_dict`` and ``serving_state_dict`` gather the
full tensors over the model group (every rank of it must call them), and
``load_train_state_dict`` takes a full state dict and keeps this rank's
slices, so a mesh checkpoint resumes in one process and the reverse.

``train_state_dict`` and ``load_train_state_dict`` are the state's on-disk
form (``ckpt.py`` writes it as ``train_state.pt``): step, count, the model's
raw state_dict (trained parameters, not the EMA; BatchNorm statistics), the
moments (full ones, gathered under ZeRO), the EMA, the route-loss EMA of
the loss-based sMRO gate and the train loop's schedule (``loop``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.utils.profiling import annotate

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def is_encoder(name: str) -> bool:
    return name.startswith("encoders.")


def leaf_trainable(name: str, finetune_text: bool, stage: str = "") -> bool:
    """Per-parameter trainability by curriculum stage, matched on the name's
    components as the JAX package matches its path keys:

    - step1 (unimodal): all but the fusions, MulT, gate net and final head;
    - step2 (bimodal): the fusions, MulT and route heads, not the encoders;
    - step3 (trimodal): the final head, the gate net and the LNI fusion;
    - "" / full and sMRO uni / bi / tri: everything (the sMRO stages freeze
      through stop-gradients or masked route-head slices instead).

    The BERT body is frozen under every stage unless finetune_text."""
    if not finetune_text and name.startswith("encoders.bbert.bert."):
        return False
    keys = set(name.split("."))

    def has(*names):
        return any(k in keys for k in names)

    if stage in ("", None, "full", "uni", "bi", "tri"):
        return True
    if stage == "step1":
        return not has("fusion", "mult", "gate_net", "final_head")
    if stage == "step2":
        return not has("encoders") and has("fusion", "mult", "route_heads")
    if stage == "step3":
        return has("final_head", "gate_net") or (has("fusion") and has("LNI"))
    raise ValueError(f"Unknown stage {stage!r}")


def n_route_loss_ema_for(cfg: Config, family: str) -> int:
    """Routes tracked by the loss-based sMRO gate's EMA: 7 for the fame
    family with model.smro_gate_mode=loss_based, else 0 (no buffer)."""
    return 7 if family == "fame" and cfg.model.smro_gate_mode == "loss_based" else 0


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    names: List[str]  # trainable parameters, in the model's order
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]  # trainable parameters' EMA (frozen ones never move)
    grad_clip: float
    weight_decay: float
    stage: str = ""
    # EMA of the per-route losses for the loss-based sMRO gate, [R] fp32; None
    # for the families that do not track it
    route_loss_ema: Optional[torch.Tensor] = None
    count: int = 0  # Adam's count: finite steps taken
    step: int = 0  # every step, finite or not
    # the train loop's schedule at the end of its last epoch (sampler and
    # dropout generator states, LR scale, plateau and best values), so that
    # a resumed run continues it; empty for a fresh state
    loop: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # ZeRO-1 (parallel/zero.py): this rank's row slices of the moments of the
    # sharded leaves; None when every rank holds the full moments
    zero: Optional[Any] = None
    # the 'model' axis's tensor / route / pipeline role (parallel/mesh.py:ModelShards):
    # the parameters of which this state holds this rank's slice; None when
    # every parameter is whole
    shards: Optional[Any] = None

    def params(self) -> List[torch.Tensor]:
        named = dict(self.model.named_parameters())
        return [named[n] for n in self.names]


def create_train_state(cfg: Config, model: nn.Module, stage: str = "", n_route_loss_ema: int = 0) -> TrainState:
    """Zero moments, an EMA equal to the parameters and, with
    `n_route_loss_ema`, a zero route-loss EMA. Marks each parameter's
    requires_grad by its trainability at `stage`."""
    finetune = cfg.encoder.finetune_text
    names = []
    for name, p in model.named_parameters():
        trainable = leaf_trainable(name, finetune, stage)
        p.requires_grad_(trainable)
        if trainable:
            names.append(name)
    named = dict(model.named_parameters())
    zeros = lambda: {n: torch.zeros_like(named[n]) for n in names}  # noqa: E731
    return TrainState(
        model=model, names=names, mu=zeros(), nu=zeros(),
        ema={n: named[n].detach().clone() for n in names} if cfg.train.use_ema else None,
        grad_clip=float(cfg.train.grad_clip), weight_decay=float(cfg.train.weight_decay), stage=stage or "",
        route_loss_ema=(
            torch.zeros(n_route_loss_ema, device=next(model.parameters()).device) if n_route_loss_ema else None
        ),
    )


def apply_gradients(
    state: TrainState,
    grads: Dict[str, torch.Tensor],
    *,
    lr_head: float,
    lr_enc: float,
    ema_decay: float,
    new_batch_stats: Optional[Dict[str, torch.Tensor]] = None,
    update_mask: Optional[Dict[str, torch.Tensor]] = None,
) -> bool:
    """One optimizer step with the finite-gradient guard; returns whether
    the gradient was finite (and the step applied). `update_mask` (by
    parameter name, broadcastable) multiplies those parameters' updates
    after Adam and weight decay, before the learning rate."""
    state.step += 1
    z, shards = state.zero, state.shards
    g = [grads[n].float() for n in state.names]
    if z is not None:  # this rank's slices of the sharded leaves
        g = [x[z.slices[n]] if n in z.slices else x for n, x in zip(state.names, g)]
    finite = True
    if g:
        all_finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
        with annotate("train.sync"):
            finite = bool(all_finite)
    if shards is not None:  # the ranks hold different slices: one verdict for the world
        finite = _world_finite(finite, shards.mesh, next(state.model.parameters()).device)
    elif z is not None:
        finite = z.all_finite(finite, next(state.model.parameters()).device)
    if not finite:
        return False
    params = state.params()
    g_norm = None
    if g:
        norms = torch.stack([torch.linalg.vector_norm(x) for x in g])
        if z is not None:  # a sharded leaf's norm from every rank's slice
            sharded = torch.tensor([n in z.slices for n in state.names], device=norms.device)
            norms = torch.where(sharded, z.sum(norms * norms).sqrt(), norms)
        if shards is not None and shards.dims:  # a model-sharded leaf counted once
            norms = shards.sum_squares(norms * norms, state.names).sqrt()
        g_norm = torch.linalg.vector_norm(norms)
    if g:
        below = g_norm < state.grad_clip
        with annotate("train.sync"):
            clip = not bool(below)
        if clip:
            g = torch._foreach_mul(torch._foreach_div(g, g_norm), state.grad_clip)
    if z is not None:  # from here on the sharded leaves are this rank's rows
        full_params, params = params, [p.data[z.slices[n]] if n in z.slices else p for n, p in zip(state.names, params)]
    mu = [state.mu[n] for n in state.names]
    nu = [state.nu[n] for n in state.names]
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - ADAM_B2)
    state.count += 1
    mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1**state.count)
    nu_hat = torch._foreach_div(nu, 1.0 - ADAM_B2**state.count)
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    with torch.no_grad():
        torch._foreach_add_(updates, params, alpha=state.weight_decay)
        for name, u in zip(state.names, updates):
            if update_mask and name in update_mask:
                mask = update_mask[name]
                u.mul_(mask[z.slices[name]] if z is not None and name in z.slices and mask.shape[0] > 1 else mask)
        for name, p, u in zip(state.names, params, updates):
            p.add_(u, alpha=-(lr_enc if is_encoder(name) else lr_head))
        if z is not None:
            for name, p in zip(state.names, full_params):
                if name in z.slices:
                    z.gather_param_(p, name)
            params = full_params
        if state.ema is not None:
            ema = [state.ema[n] for n in state.names]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        if new_batch_stats:
            buffers = dict(state.model.named_buffers())
            for key, value in new_batch_stats.items():
                buffers[key].copy_(value)
    return True


def _world_finite(finite: bool, mesh, device) -> bool:
    """Whether every rank of the world saw finite gradients."""
    from multimodalrouting_tpu_torch.parallel.mesh import all_reduce_

    bad = all_reduce_(torch.tensor([0.0 if finite else 1.0], device=device), mesh.world)
    return bool(bad.item() == 0.0)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The model with its trainable parameters swapped for their EMA (no
    copy), swapped back on exit; the model as it is without an EMA."""
    if state.ema is None:
        yield state.model
        return
    params = state.params()
    for name, p in zip(state.names, params):
        p.data, state.ema[name] = state.ema[name], p.data
    try:
        yield state.model
    finally:
        for name, p in zip(state.names, params):
            p.data, state.ema[name] = state.ema[name], p.data


def _full(state: TrainState, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`tensors` whole: model-sharded ones gathered over the model group."""
    return tensors if state.shards is None else state.shards.full_dict(tensors)


def serving_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The weights a checkpoint serves: the EMA where the run keeps one,
    whole (gathered over the model group: every rank of it must call this
    where the state holds slices)."""
    with ema_weights(state) as model:
        return {k: v.detach().clone() for k, v in _full(state, model.state_dict()).items()}


def train_state_dict(state: TrainState) -> Dict[str, Any]:
    """Everything a resume needs, as CPU tensors and plain values."""

    def cpu(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    mu, nu = state.mu, state.nu
    if state.zero is not None:  # the full moments, from every rank of the data group
        from multimodalrouting_tpu_torch.parallel.zero import gather_moments

        mu, nu = gather_moments(state)
    return {  # whole tensors, from every rank of the model group where the state holds slices
        "step": state.step, "count": state.count, "model": cpu(_full(state, state.model.state_dict())),
        "mu": cpu(_full(state, mu)), "nu": cpu(_full(state, nu)),
        "ema": None if state.ema is None else cpu(_full(state, state.ema)),
        "route_loss_ema": None if state.route_loss_ema is None else state.route_loss_ema.detach().cpu(),
        "loop": dict(state.loop),
    }


def load_train_state_dict(state: TrainState, saved: Dict[str, Any], *, params_only: bool = False) -> TrainState:
    """Load `saved` (``train_state_dict``'s form, in the model's BERT layout)
    into `state` in place, each tensor cast to the dtype `state` holds it in.

    A full load takes step, count, weights, buffers, moments, EMA, the
    route-loss EMA and the loop's schedule. ``params_only`` takes the
    weights, buffers, EMA and route-loss EMA and keeps the fresh moments,
    count, step and schedule (stage chaining carries the route-loss EMA
    across stages, as the reference's trainer does). Under ``params_only``
    the checkpoint's weights that the model lacks are left out (a loss-based
    stage warm-started from a learned gate's), as flax's ``from_state_dict``
    leaves them; a weight the checkpoint lacks raises either way. An EMA the
    checkpoint lacks, or lacks for a parameter, starts from the restored
    parameter; a route-loss EMA it lacks (a checkpoint from before the
    buffer, or of another gate) stays as `state` holds it. A state that holds
    model-sharded slices (``shards``) takes this rank's slices of the full
    tensors."""
    if not params_only and sorted(saved["mu"]) != sorted(state.names):
        raise ValueError(
            f"the checkpoint's optimizer covers {len(saved['mu'])} parameters and this run trains "
            f"{len(state.names)}; a full restore needs the same trainable set (warm-start with --init-from)"
        )
    local = (lambda n, v: v) if state.shards is None else state.shards.local  # noqa: E731
    weights = saved["model"]
    if params_only:  # flax's from_state_dict walks the model's keys: a stage's extra weights are left out
        own = state.model.state_dict()
        weights = {k: v for k, v in weights.items() if k in own}
    state.model.load_state_dict({k: local(k, v) for k, v in weights.items()})
    with torch.no_grad():
        if state.ema is not None:
            ema = saved.get("ema") or {}
            for n in state.names:
                state.ema[n].copy_(local(n, ema.get(n, saved["model"][n])))
        rle = saved.get("route_loss_ema")
        if state.route_loss_ema is not None and rle is not None:
            state.route_loss_ema.copy_(rle)
        if not params_only:
            rows = state.zero.slices if state.zero is not None else {}
            for n in state.names:  # under ZeRO this rank's rows of the full moments
                mu, nu = local(n, saved["mu"][n]), local(n, saved["nu"][n])
                if n in rows:
                    mu, nu = mu[rows[n]], nu[rows[n]]
                state.mu[n].copy_(mu)
                state.nu[n].copy_(nu)
    if not params_only:
        state.count, state.step, state.loop = int(saved["count"]), int(saved["step"]), dict(saved.get("loop") or {})
    return state
