"""The capsule family's train and eval steps (counterpart of
multimodalrouting_tpu/train/steps.py).

A train step: route mask from presence with route dropout, the training
forward, the death-logit BCE (label smoothing, optional clamped pos_weight
or focal loss) plus the routing regularizers and the CheXpert auxiliary
term, the backward, microbatch gradient accumulation, then
``state.apply_gradients`` with the new BatchNorm statistics. The eval step
runs the EMA weights. Randomness (route dropout, every dropout) comes from
the ``torch.Generator`` the caller passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.routes import ROUTE_REQUIRES, get_routes, route_mask_from_presence
from multimodalrouting_tpu_torch.train.losses import (
    bce_with_logits,
    clamped_pos_weight,
    death_logit,
    focal_bce_with_logits,
    routing_regularizers,
)
from multimodalrouting_tpu_torch.train.state import TrainState, apply_gradients, ema_weights


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    task_loss: torch.Tensor
    reg_loss: torch.Tensor
    grad_finite: bool
    alpha_mean: Optional[torch.Tensor] = None  # [R] batch-mean route activations


def _capsule_only(family: str) -> None:
    if family != "capsule":
        raise NotImplementedError(f"the {family!r} family's steps are not ported yet (ROADMAP.md)")


def apply_route_dropout(route_mask: torch.Tensor, routes, generator: Optional[torch.Generator], p: float):
    """With probability p per sample, zero one randomly chosen interaction route."""
    if p <= 0.0:
        return route_mask
    b, r = route_mask.shape
    dev = route_mask.device
    inter_idx = torch.tensor([i for i, name in enumerate(routes) if len(ROUTE_REQUIRES[name]) > 1], device=dev)
    choice = inter_idx[torch.randint(0, len(inter_idx), (b,), generator=generator, device=dev)]
    do_drop = torch.rand((b,), generator=generator, device=dev) < p
    drop = F.one_hot(choice, r).to(route_mask.dtype) * do_drop[:, None].to(route_mask.dtype)
    return route_mask * (1.0 - drop)


def task_loss(cfg: Config, out, batch: Batch, route_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(task, reg) of the capsule family (JAX steps.py:84-113)."""
    t, m = cfg.train, cfg.model
    y = batch.y
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


def make_train_step(cfg: Config, model, family: str = "capsule"):
    """-> train_step(state, batch, generator, lr_head, lr_enc, detach_priors,
    act_temperature, note_pack) -> StepMetrics; the state is updated in
    place. `batch` holds tensors on the model's device."""
    _capsule_only(family)
    routes = get_routes(cfg.model.routes)
    t = cfg.train
    n_micro = max(int(t.microbatch), 0)

    def forward_loss(batch: Batch, generator, detach_priors, act_temperature, note_pack):
        rm = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, routes)
        rm = apply_route_dropout(rm, routes, generator, t.route_dropout_p)
        out = model(
            batch, train=True, route_mask=rm, detach_priors=detach_priors, act_temperature=act_temperature,
            generator=generator, note_pack=note_pack,
        )
        task, reg = task_loss(cfg, out, batch, rm)
        if t.chexpert_weight > 0.0 and batch.chexpert is not None:
            # CheXpert 14-class auxiliary BCE over image-present samples
            has_i = batch.has_i.float()
            cx = bce_with_logits(out.chexpert_logits, batch.chexpert, sample_weight=has_i, reduce=False)
            reg = reg + t.chexpert_weight * cx.sum() / (torch.clamp(has_i.sum(), min=1.0) * cx.shape[-1])
        return task + reg, task, reg, out

    def train_step(
        state: TrainState,
        batch: Batch,
        generator: Optional[torch.Generator],
        lr_head: float,
        lr_enc: float,
        detach_priors: bool = False,
        act_temperature=None,
        note_pack: int = 0,
    ) -> StepMetrics:
        params = state.params()
        for p in params:
            p.grad = None
        if n_micro > 1:
            # each microbatch starts from the old BatchNorm statistics and the
            # last one's update is kept; packing is off (the capacity is the
            # full batch's)
            mb = batch.batch_size // n_micro
            loss = task = reg = 0.0
            for i in range(n_micro):
                sub = Batch(*(None if v is None else v[i * mb : (i + 1) * mb] for v in batch))
                li, ti, ri, out = forward_loss(sub, generator, detach_priors, act_temperature, 0)
                li.backward()
                loss, task, reg = loss + li.detach(), task + ti.detach(), reg + ri.detach()
            scale = 1.0 / n_micro
            loss, task, reg = loss * scale, task * scale, reg * scale
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
        else:
            loss, task, reg, out = forward_loss(batch, generator, detach_priors, act_temperature, note_pack)
            loss.backward()
            loss, task, reg = loss.detach(), task.detach(), reg.detach()
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in zip(state.names, params)}
        finite = apply_gradients(
            state, grads, lr_head=lr_head, lr_enc=lr_enc, ema_decay=t.ema_decay, new_batch_stats=out.batch_stats,
        )
        for p in params:
            p.grad = None
        return StepMetrics(
            loss=loss, task_loss=task, reg_loss=reg, grad_finite=finite,
            alpha_mean=None if out.alpha is None else out.alpha.detach().mean(dim=0),
        )

    return train_step


def make_eval_step(cfg: Config, model, family: str = "capsule", use_ema: bool = True):
    """-> eval_step(state, batch, note_pack=0) -> ModelOutput of the EMA
    weights (or the raw ones without an EMA or with use_ema=False)."""
    _capsule_only(family)
    routes = get_routes(cfg.model.routes)

    def eval_step(state: TrainState, batch: Batch, note_pack: int = 0):
        rm = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, routes)
        with torch.no_grad():
            if use_ema:
                with ema_weights(state) as m:
                    return m(batch, train=False, route_mask=rm, note_pack=note_pack)
            return model(batch, train=False, route_mask=rm, note_pack=note_pack)

    return eval_step
