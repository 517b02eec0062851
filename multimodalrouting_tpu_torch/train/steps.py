"""The train and eval steps of every family (counterpart of
multimodalrouting_tpu/train/steps.py).

A train step: the training forward (the capsule family with its route mask
from presence and route dropout), the family's loss, the CheXpert auxiliary
term, the backward, microbatch gradient accumulation, then
``state.apply_gradients`` with the new BatchNorm statistics. The losses:

- capsule: the death-logit BCE (label smoothing, optional clamped
  pos_weight or focal loss), or the phenotypes' clamped-pos_weight BCE,
  plus the routing regularizers;
- gated_concat: at step1 / step2 the mean BCE of the stage's route heads;
  else the final head's BCE, the aux LNI route's (``aux_lni_weight``) and
  optionally every route's (``per_route_aux_weight``); plus the fairness
  term;
- fame (and the baselines, which train under it): BCE plus the fairness
  term (EDDI or soft equalized odds on the first head, ``fairness_gamma``).

Under the loss-based sMRO gate (fame, ``smro_gate_mode=loss_based``) the
step keeps the EMA of each route's BCE (of stop-gradient route logits;
``route_loss_ema_beta``; frozen on a non-finite step) and, at the stages
uni / bi / tri, masks the route heads outside the stage's block on the
gradients and on the post-optimizer updates. The eval step runs the EMA
weights, with the trained route-loss EMA. Randomness (route dropout, every
dropout) comes from the ``torch.Generator`` the caller passes; route dropout
from ``route_generator`` where one is given.

On a mesh (``parallel/mesh.py``) the step computes the JAX package's
global-batch numbers from each rank's rows: the BatchNorm moments (in
``models/cxr.py``), the clamped pos_weight and the fairness penalties (in
``losses.py``) and the CheXpert term's ratio are sums over the data group;
route dropout is drawn for the global batch and sliced; the gradients are
averaged over the world, this rank's slices of model-sharded parameters
(the 'model' axis's tensor, route and pipeline roles) over the data group;
the logged losses, the route-loss EMA's per-route losses and the alpha and
gate means are data-group means. Under ``train.microbatch`` = k > 1 the
local batch holds each global microbatch's slice of this data shard, in
order (``parallel/mesh.shard_batch``): local microbatch i is then the
data shard's share of the JAX step's microbatch i, and the global sums
above are that microbatch's (its BatchNorm statistics, of which the last
microbatch's are kept, its pos_weight, its fairness and CheXpert terms).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch, slice_batch
from multimodalrouting_tpu_torch.parallel.mesh import (
    average_gradients,
    data_rows,
    get_active_mesh,
    global_mean,
    global_sum,
)
from multimodalrouting_tpu_torch.routes import ROUTE_REQUIRES, get_blocks, get_routes, route_mask_from_presence
from multimodalrouting_tpu_torch.train.losses import (
    bce_with_logits,
    clamped_pos_weight,
    death_logit,
    eddi_loss,
    focal_bce_with_logits,
    routing_regularizers,
    soft_eq_odds_loss,
)
from multimodalrouting_tpu_torch.train.state import TrainState, apply_gradients, ema_weights
from multimodalrouting_tpu_torch.utils.profiling import annotate


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    task_loss: torch.Tensor
    reg_loss: torch.Tensor
    grad_finite: bool
    alpha_mean: Optional[torch.Tensor] = None  # [R] batch-mean route activations
    gates_mean: Optional[torch.Tensor] = None  # batch-mean gate weights


LOSS_FAMILIES = ("capsule", "gated_concat", "fame")


def loss_family(family: str) -> str:
    """The loss family a model family trains and evaluates under: the
    baselines (late_fusion, trimf) under fame's, as the JAX CLI runs them."""
    return family if family in LOSS_FAMILIES else "fame"


def step_routes(cfg: Config, family: str):
    """The routes of a family's step: the capsule config's, else always 7."""
    return get_routes(cfg.model.routes if family == "capsule" else "7")


def tracks_route_ema(cfg: Config, family: str) -> bool:
    return family == "fame" and cfg.model.smro_gate_mode == "loss_based"


def apply_route_dropout(route_mask: torch.Tensor, routes, generator: Optional[torch.Generator], p: float):
    """With probability p per sample, zero one randomly chosen interaction
    route. On a mesh the draws are the global batch's (`generator` the same
    on every rank), of which this rank takes its rows."""
    if p <= 0.0:
        return route_mask
    b, r = route_mask.shape
    n, lo = data_rows(b)
    dev = route_mask.device
    inter_idx = torch.tensor([i for i, name in enumerate(routes) if len(ROUTE_REQUIRES[name]) > 1], device=dev)
    choice = inter_idx[torch.randint(0, len(inter_idx), (n,), generator=generator, device=dev)[lo : lo + b]]
    do_drop = torch.rand((n,), generator=generator, device=dev)[lo : lo + b] < p
    drop = F.one_hot(choice, r).to(route_mask.dtype) * do_drop[:, None].to(route_mask.dtype)
    return route_mask * (1.0 - drop)


def fairness_reg(cfg: Config, out, batch: Batch, y2: torch.Tensor) -> torch.Tensor:
    """gamma times the differentiable fairness penalty on the first head."""
    t = cfg.train
    if t.fairness_gamma <= 0.0 or batch.sens is None:
        return torch.zeros((), dtype=torch.float32, device=out.logits.device)
    probs = torch.sigmoid(out.logits[:, 0].float())
    pen = (soft_eq_odds_loss if t.fairness_kind == "eq_odds" else eddi_loss)(probs, y2[:, 0], batch.sens)
    return t.fairness_gamma * pen


def per_route_bce(route_logits: torch.Tensor, y2: torch.Tensor, **kw) -> torch.Tensor:
    """BCE of [B, R, K] route logits against the labels [B, K] of every route."""
    return bce_with_logits(route_logits, y2[:, None, :].expand_as(route_logits), **kw)


def task_loss(cfg: Config, family: str, out, batch: Batch, route_mask,
              stage: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """(task, reg) of the family's loss (JAX steps.py:84-148)."""
    t, m = cfg.train, cfg.model
    y = batch.y
    if family == "gated_concat":
        y2 = y if y.dim() == 2 else y[:, None]
        if stage in ("step1", "step2"):
            sel = slice(0, 3) if stage == "step1" else slice(3, 6)
            return per_route_bce(out.route_logits[:, sel, :], y2, label_smoothing=t.label_smoothing), \
                fairness_reg(cfg, out, batch, y2)
        task = bce_with_logits(out.logits, y2, label_smoothing=t.label_smoothing)
        if t.aux_lni_weight > 0.0:
            task = task + t.aux_lni_weight * bce_with_logits(out.route_logits[:, -1, :], y2)
        if t.per_route_aux_weight > 0.0:
            task = task + t.per_route_aux_weight * per_route_bce(out.route_logits, y2)
        return task, fairness_reg(cfg, out, batch, y2)
    if family == "fame":
        y2 = y if y.dim() == 2 else y[:, None]
        return bce_with_logits(out.logits, y2, label_smoothing=t.label_smoothing), fairness_reg(cfg, out, batch, y2)
    if family != "capsule":
        raise ValueError(f"Unknown family {family!r}")
    if m.task == "mort":
        logit = death_logit(out.logits) if m.num_classes == 2 else out.logits[:, 0]
        if t.use_focal:
            task = focal_bce_with_logits(logit, y, gamma=t.focal_gamma, alpha=t.focal_alpha)
        else:
            pw = None
            if t.sampler_mode in ("pos_weight", "hybrid"):
                pw = clamped_pos_weight(y[:, None], *t.pos_weight_clip)[0]
            task = bce_with_logits(logit, y, pos_weight=pw, label_smoothing=t.label_smoothing)
    else:  # pheno multi-label
        pw = clamped_pos_weight(y, *t.pos_weight_clip)
        task = bce_with_logits(out.logits, y, pos_weight=pw, label_smoothing=t.label_smoothing)
    reg = routing_regularizers(
        out.r_matrix, route_mask, entropy_bonus=t.routing_entropy_bonus, uniform_penalty=t.routing_uniform_penalty,
    )
    return task, reg


def make_train_step(cfg: Config, model, family: str = "capsule", **apply_kwargs):
    """-> train_step(state, batch, generator, lr_head, lr_enc, detach_priors,
    act_temperature, note_pack) -> StepMetrics; the state is updated in
    place. `batch` holds tensors on the model's device. `family` is the
    loss family (capsule, gated_concat or fame); `apply_kwargs` go to the
    model's forward (``stage``)."""
    if family not in LOSS_FAMILIES:
        raise ValueError(f"Unknown family {family!r}")
    routes = step_routes(cfg, family)
    t = cfg.train
    n_micro = max(int(t.microbatch), 0)
    stage = apply_kwargs.get("stage", "")
    track_ema = tracks_route_ema(cfg, family)
    # the loss-based sMRO curriculum freezes the route heads outside the
    # stage's block: a [R] 0/1 mask along the stacked route axis
    head_keep = None
    if track_ema and stage in ("uni", "bi", "tri"):
        keep = set(get_blocks(routes)[stage])
        head_keep = torch.tensor([1.0 if i in keep else 0.0 for i in range(len(routes))])

    def forward_loss(state, batch: Batch, generator, route_gen, detach_priors, act_temperature, note_pack):
        kwargs = dict(apply_kwargs)
        rm = None
        if family == "capsule":
            rm = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, routes)
            rm = apply_route_dropout(rm, routes, route_gen, t.route_dropout_p)
            kwargs.update(route_mask=rm, detach_priors=detach_priors, act_temperature=act_temperature)
        if track_ema:
            kwargs["route_losses_ema"] = state.route_loss_ema
        out = model(batch, train=True, generator=generator, note_pack=note_pack, **kwargs)
        task, reg = task_loss(cfg, family, out, batch, rm, stage=stage)
        if t.chexpert_weight > 0.0 and batch.chexpert is not None:
            # CheXpert 14-class auxiliary BCE over image-present samples
            has_i = batch.has_i.float()
            cx = bce_with_logits(out.chexpert_logits, batch.chexpert, sample_weight=has_i, reduce=False)
            sums = global_sum(torch.stack([cx.sum(), has_i.sum()]))  # the global batch's ratio
            reg = reg + t.chexpert_weight * sums[0] / (torch.clamp(sums[1], min=1.0) * cx.shape[-1])
        per_route = None
        if track_ema:  # observation only: plain per-route BCE of the stopped route logits
            y2 = batch.y if batch.y.dim() == 2 else batch.y[:, None]
            per_route = per_route_bce(out.route_logits.detach(), y2, reduce=False).mean(dim=(0, 2))
        return task + reg, task, reg, out, per_route

    def train_step(
        state: TrainState,
        batch: Batch,
        generator: Optional[torch.Generator],
        lr_head: float,
        lr_enc: float,
        detach_priors: bool = False,
        act_temperature=None,
        note_pack: int = 0,
        route_generator: Optional[torch.Generator] = None,
    ) -> StepMetrics:
        params = state.params()
        route_gen = generator if route_generator is None else route_generator
        for p in params:
            p.grad = None
        if n_micro > 1:
            # each microbatch starts from the old BatchNorm statistics and the
            # last one's update is kept; packing is off (the capacity is the
            # full batch's)
            if get_active_mesh() is not None and batch.batch_size % n_micro:
                raise ValueError(f"a data shard's {batch.batch_size} rows do not hold train.microbatch="
                                 f"{n_micro} equal slices: lay them out with parallel/mesh.shard_batch")
            mb = batch.batch_size // n_micro
            loss = task = reg = 0.0
            per_route = None
            for i in range(n_micro):
                sub = slice_batch(batch, i * mb, mb)
                with annotate("train.forward"):
                    li, ti, ri, out, pi = forward_loss(state, sub, generator, route_gen, detach_priors,
                                                       act_temperature, 0)
                with annotate("train.backward"):
                    li.backward()
                loss, task, reg = loss + li.detach(), task + ti.detach(), reg + ri.detach()
                if pi is not None:
                    per_route = pi if per_route is None else per_route + pi
            scale = 1.0 / n_micro
            loss, task, reg = loss * scale, task * scale, reg * scale
            if per_route is not None:
                per_route = per_route * scale
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
        else:
            with annotate("train.forward"):
                loss, task, reg, out, per_route = forward_loss(
                    state, batch, generator, route_gen, detach_priors, act_temperature, note_pack)
            with annotate("train.backward"):
                loss.backward()
            loss, task, reg = loss.detach(), task.detach(), reg.detach()
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in zip(state.names, params)}
        # on a mesh: each rank's gradient of its own loss, averaged over the
        # world (model-sharded slices over the data group), is the global
        # batch's (parallel/mesh.py)
        sharded = () if state.shards is None else [n in state.shards.dims for n in grads]
        average_gradients(list(grads.values()), sharded)
        update_mask = None
        if head_keep is not None:
            # on the gradients (Adam's moments of the frozen slices stay zero)
            # and on the updates (decoupled weight decay cannot move them)
            update_mask = {}
            for n in state.names:
                if "route_heads" in n.split("."):
                    update_mask[n] = head_keep.to(grads[n].device).reshape((-1,) + (1,) * (grads[n].dim() - 1))
                    grads[n] = grads[n] * update_mask[n]
        with annotate("train.optimizer"):
            finite = apply_gradients(
                state, grads, lr_head=lr_head, lr_enc=lr_enc, ema_decay=t.ema_decay,
                new_batch_stats=out.batch_stats, update_mask=update_mask,
            )
        for p in params:
            p.grad = None
        alpha_mean = None if out.alpha is None else out.alpha.detach().mean(dim=0)
        gates_mean = None if out.gates is None else out.gates.detach().mean(dim=0)
        if get_active_mesh() is not None:  # the data shards' means of equal-size shards, in one all-reduce
            parts = [loss, task, reg, per_route, alpha_mean, gates_mean]
            have = [x for x in parts if x is not None]
            flat = global_mean(torch.cat([x.float().reshape(-1) for x in have]))
            it = iter(flat.split([x.numel() for x in have]))
            loss, task, reg, per_route, alpha_mean, gates_mean = (
                None if x is None else next(it).view_as(x).to(x.dtype) for x in parts)
        ema = state.route_loss_ema
        if per_route is not None and ema is not None and finite:
            all_finite = torch.isfinite(per_route).all()
            with annotate("train.sync"):
                ema_finite = bool(all_finite)
            if ema_finite:
                beta = t.route_loss_ema_beta
                ema.mul_(beta).add_(per_route, alpha=1.0 - beta)
        return StepMetrics(loss=loss, task_loss=task, reg_loss=reg, grad_finite=finite, alpha_mean=alpha_mean,
                           gates_mean=gates_mean)

    @functools.wraps(train_step)
    def spanned_step(*args, **kwargs) -> StepMetrics:
        with annotate("train.step"):
            return train_step(*args, **kwargs)

    return spanned_step


def make_eval_step(cfg: Config, model, family: str = "capsule", use_ema: bool = True, **apply_kwargs):
    """-> eval_step(state, batch, note_pack=0) -> ModelOutput of the EMA
    weights (or the raw ones without an EMA or with use_ema=False), with the
    trained route-loss EMA under the loss-based sMRO gate."""
    if family not in LOSS_FAMILIES:
        raise ValueError(f"Unknown family {family!r}")
    routes = step_routes(cfg, family)
    track_ema = tracks_route_ema(cfg, family)

    def eval_step(state: TrainState, batch: Batch, note_pack: int = 0):
        kwargs = dict(apply_kwargs)
        if family == "capsule":
            kwargs["route_mask"] = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, routes)
        if track_ema:
            kwargs["route_losses_ema"] = state.route_loss_ema
        with torch.no_grad():
            if use_ema:
                with ema_weights(state) as m:
                    return m(batch, train=False, note_pack=note_pack, **kwargs)
            return model(batch, train=False, note_pack=note_pack, **kwargs)

    return eval_step
