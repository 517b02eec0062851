"""The epoch-level training loop of every family on one device over a dense
split (counterpart of multimodalrouting_tpu/train/loop.py:32-87 and
:152-572). ``family`` is the loss family (capsule, gated_concat or fame;
the baselines train under fame) and ``stage`` the curriculum stage: the
train step runs the stage's forward (gated step1 / step2 / step3, fame uni
/ bi / tri), and the evaluation fuses only the trained blocks mid-curriculum
(gated step1 / step2, fame uni / bi), as the JAX loop does.

Weighted positive sampling (sqrt-clipped) with the JAX package's numpy
sample order from ``train.seed``, optional chunk bucketing, the chunk-pack
capacity per batch, encoder LR warm-up, detach-priors epochs, the
act-temperature anneal, ReduceLROnPlateau on validation AUROC, early
stopping, EMA evaluation, best / best_f1 / last / final checkpoints
(``ckpt.py``: EMA weights as the serving weights, and the train state),
post-training temperature and threshold calibration and the validation
reliability diagram.

A run given no state starts from a fresh train state, after copying the
pretrained encoder weights the config names (``encoder.bert_weights`` /
``encoder.vision_weights``, ``pretrained.py``) into the model, so that the
EMA starts from them, as the JAX loop does. A run given a restored state
starts at epoch ``state.step // steps_per_epoch``, as the JAX loop does.
Unlike the JAX loop, it also continues the schedule the checkpoint carries
(``state.loop``: the sampler's and the dropout generator's states, the LR
scale, the plateau count and the best values), so that one epoch and a
resume to two give the same state as two epochs without a break.

With ``encoder.text_embedding_cache`` the frozen BERT body runs once over
each split after the state exists (``train/text_cache.py``), and every
step and evaluation starts from the cached chunk embeddings.

A streaming split (``data/streaming.py:StreamingSplit``, ``data.stream``)
is pulled batch by batch through its ``epoch_iter`` instead of sliced, with
the JAX loop's rules: ``train.sampler_mode`` sqrt / hybrid switch on the
split's streaming resampler (``enable_sampler``), and chunk bucketing, which
needs random access, raises ``ValueError``. Its resume restarts at the
epoch the step implies, and that epoch's stream is drawn again from the
split's seed plus the epoch, as the JAX loop does.

Not ported: meshes (ROADMAP.md §1 item 12); they raise, as do background
checkpoint saves (``train.ckpt_backend=orbax_async``, item 13).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from multimodalrouting_tpu_torch.audit.exports import save_reliability_diagram
from multimodalrouting_tpu_torch.ckpt import TRAIN_STATE, save_checkpoint
from multimodalrouting_tpu_torch.configs import Config, to_dict
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to, slice_batch, take_batch
from multimodalrouting_tpu_torch.metrics.calibration import find_best_thresholds, fit_temperature
from multimodalrouting_tpu_torch.metrics.classification import epoch_metrics
from multimodalrouting_tpu_torch.parallel.pp import validate_pp
from multimodalrouting_tpu_torch.pretrained import apply_pretrained
from multimodalrouting_tpu_torch.serve import probs_from_logits
from multimodalrouting_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    n_route_loss_ema_for,
    serving_state_dict,
    train_state_dict,
)
from multimodalrouting_tpu_torch.train.steps import make_eval_step, make_train_step
from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache


def weighted_sample_order(y: np.ndarray, rng: np.random.Generator, mode: str = "sqrt") -> np.ndarray:
    """WeightedRandomSampler equivalent: positives up-weighted by
    clip(sqrt(neg / pos), 1, 5), drawn with replacement."""
    n = len(y)
    y_bin = np.asarray(y).reshape(n, -1)[:, 0] > 0.5
    if mode in ("none", "", "pos_weight"):
        return rng.permutation(n)
    pos = max(int(y_bin.sum()), 1)
    neg = max(n - pos, 1)
    w_pos = float(np.clip(np.sqrt(neg / pos), 1.0, 5.0))
    weights = np.where(y_bin, w_pos, 1.0)
    weights = weights / weights.sum()
    return rng.choice(n, size=n, replace=True, p=weights)


def chunk_bucketed_order(order: np.ndarray, chunk_mask: np.ndarray, batch_size: int, rng: np.random.Generator):
    """Regroup a sampled order so each batch has homogeneous note-chunk
    counts (the same sampled multiset), then shuffle the batch order."""
    counts = np.asarray(chunk_mask).sum(axis=1)[order]
    regrouped = order[np.argsort(counts, kind="stable")]
    n_full = (len(order) // batch_size) * batch_size
    batches = regrouped[:n_full].reshape(-1, batch_size)
    perm = rng.permutation(len(batches))
    return np.concatenate([batches[perm].reshape(-1), regrouped[n_full:]])


def note_pack_bucket(cfg: Config, batch: Batch) -> int:
    """Chunk-pack capacity for this batch (0 = packing off): covers every
    valid chunk, rounded up to a grid of max(16, total / 8)."""
    if batch.note_chunk_embs is not None or not cfg.encoder.note_pack or batch.chunk_mask is None:
        return 0
    cm = np.asarray(batch.chunk_mask)
    total = int(cm.size)
    g = max(16, total // 8)
    cap = int(np.ceil(max(int(cm.sum()), 1) / g) * g)
    return 0 if cap >= total else cap


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: List[Dict[str, float]]
    best_metric: float
    thresholds: Optional[np.ndarray]
    temperature: float


def predict_probs(eval_step, state: TrainState, cohort: Batch, batch_size: int, task: str):
    """Full-split inference in slices of `batch_size` -> (probs, alpha
    [N, R], r_matrix [N, R, K]) on the host; the route audit is None where
    the model gives none."""
    dev = next(state.model.parameters()).device
    probs, alphas, rms = [], [], []
    for start in range(0, cohort.batch_size, batch_size):
        out = eval_step(state, batch_to(slice_batch(cohort, start, batch_size), dev))
        probs.append(probs_from_logits(out.logits.cpu().numpy(), task))
        if out.alpha is not None:
            alphas.append(out.alpha.cpu().numpy())
        if out.r_matrix is not None:
            rms.append(out.r_matrix.cpu().numpy())
    cat = lambda xs: np.concatenate(xs, 0) if xs else None  # noqa: E731
    return cat(probs), cat(alphas), cat(rms)


def train_model(
    cfg: Config,
    model,
    train_cohort: Batch,
    val_cohort: Batch,
    *,
    family: str = "capsule",
    stage: str = "",
    state: Optional[TrainState] = None,
    log_fn: Callable[[str], None] = print,
    ckpt_dir: Optional[str] = None,
) -> TrainResult:
    """Train `model` (from ``build_model(..., train=True)``, on its device)
    on numpy cohorts under the loss `family` at curriculum `stage`, from
    `state` where given (a restored one resumes); checkpoints go to
    ``ckpt_dir/<best|best_f1|last|final>``."""
    t, m = cfg.train, cfg.model
    if t.num_data_shards * t.num_model_shards > 1:
        if t.pipeline_parallel:  # the JAX package's checks and messages first
            validate_pp(cfg, t.num_model_shards)
        raise NotImplementedError("device meshes are not ported yet (ROADMAP.md §1 item 12)")
    streaming = hasattr(train_cohort, "epoch_iter")
    if cfg.encoder.text_embedding_cache and streaming:  # the JAX package's check and message first
        raise ValueError(
            "encoder.text_embedding_cache needs a dense split; "
            "unset data.stream (streaming re-draws batches every epoch)"
        )
    if streaming:
        # sequential pulls: the samplers and bucketing that need random
        # access get the JAX loop's streaming rules and messages
        if t.sampler_mode not in ("", "none", "pos_weight"):
            if hasattr(train_cohort, "enable_sampler"):
                train_cohort.enable_sampler(t.sampler_mode)
            else:
                raise ValueError(
                    f"train.sampler_mode={t.sampler_mode!r} needs random access; "
                    "this streaming split supports 'none' or 'pos_weight' "
                    "(use data.stream_shuffle_buffer for shuffling)"
                )
        if t.chunk_bucketing:
            raise ValueError("train.chunk_bucketing needs random access; "
                             "disable it for streaming splits")
    if ckpt_dir and t.ckpt_backend == "orbax_async":
        raise NotImplementedError("background checkpoint saves are not ported yet (ROADMAP.md §1 item 13)")
    rng = np.random.default_rng(t.seed)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(t.seed)
    if state is None:
        if cfg.encoder.bert_weights or cfg.encoder.vision_weights:
            # a fresh init only, and before the state: its EMA starts from them
            apply_pretrained(cfg, model, log_fn=log_fn)
        state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=n_route_loss_ema_for(cfg, family))
    if cfg.encoder.text_embedding_cache:
        # the frozen BERT body once over each split; every step and
        # evaluation then starts from the cached chunk embeddings
        t0 = time.perf_counter()
        train_cohort = attach_note_cache(cfg, model, train_cohort)
        val_cohort = attach_note_cache(cfg, model, val_cohort)
        log_fn(f"[text-cache] frozen-BERT chunk embeddings precomputed for "
               f"{train_cohort.batch_size}+{val_cohort.batch_size} stays in {time.perf_counter() - t0:.1f}s")
    staged = (family == "fame" and stage in ("uni", "bi", "tri")) or (
        family == "gated_concat" and stage in ("step1", "step2", "step3"))
    train_step = make_train_step(cfg, model, family, **({"stage": stage} if staged else {}))
    # mid-curriculum evaluation fuses only the trained blocks: the stage's
    # route heads (gated step1 / step2) or the stage-masked gates (fame uni / bi)
    eval_staged = (family == "gated_concat" and stage in ("step1", "step2")) or (
        family == "fame" and stage in ("uni", "bi"))
    eval_step = make_eval_step(cfg, model, family, use_ema=t.use_ema, **({"stage": stage} if eval_staged else {}))

    n_train = train_cohort.batch_size
    if t.max_train_patients > 0:
        n_train = min(n_train, t.max_train_patients)
    steps_per_epoch = max(n_train // t.batch_size, 1)
    if cfg.verbose:
        log_fn(f"[config] {json.dumps(to_dict(cfg), sort_keys=True)}")
        log_fn(f"[train] family={family} stage={stage or '-'} n_train={n_train} "
               f"steps/epoch={steps_per_epoch} mesh=none")

    def save(name: str, **meta) -> None:
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(ckpt_dir, name), serving_state_dict(state), cfg,
                               train_state=train_state_dict(state), **meta)
        size = os.path.getsize(os.path.join(path, TRAIN_STATE))
        log_fn(f"[ckpt] {name}: {TRAIN_STATE} {size} bytes, saved in {time.perf_counter() - t0:.2f}s")

    lr_scale = 1.0
    best_metric, best_epoch, best_f1 = -np.inf, -1, -np.inf
    plateau_count = 0
    if state.loop:  # a restored state continues its run's schedule
        rng.bit_generator.state = state.loop["sampler"]
        generator.set_state(state.loop["generator"])
        lr_scale, plateau_count = state.loop["lr_scale"], state.loop["plateau_count"]
        best_metric, best_epoch, best_f1 = state.loop["best_metric"], state.loop["best_epoch"], state.loop["best_f1"]
    history: List[Dict[str, float]] = []
    for epoch in range(state.step // steps_per_epoch, t.epochs):
        if streaming:
            batch_iter = train_cohort.epoch_iter(epoch, t.batch_size)
        else:
            order = weighted_sample_order(np.asarray(train_cohort.y)[:n_train], rng, mode=t.sampler_mode)
            if t.chunk_bucketing and train_cohort.chunk_mask is not None:
                order = chunk_bucketed_order(order, np.asarray(train_cohort.chunk_mask), t.batch_size, rng)
        lr_enc = 0.0 if epoch < t.encoder_warmup_epochs else t.encoder_lr * lr_scale
        detach = epoch < t.detach_priors_epochs
        act_temp = None
        if family == "capsule" and m.act_temperature_start > 0 and m.act_temperature_epochs > 0:
            frac = min(epoch / max(m.act_temperature_epochs, 1), 1.0)
            act_temp = torch.tensor(
                m.act_temperature_start + frac * (m.act_temperature - m.act_temperature_start), device=dev
            )
        t0 = time.perf_counter()
        losses, skipped, alpha_mean = [], 0, None
        for s in range(steps_per_epoch):
            if streaming:
                sub = next(batch_iter, None)
                if sub is None:
                    break  # the resampled stream ran short of a full epoch
            else:
                sub = take_batch(train_cohort, order[s * t.batch_size : (s + 1) * t.batch_size])
            metrics = train_step(
                state, batch_to(sub, dev), generator, t.lr * lr_scale, lr_enc,
                detach_priors=detach, act_temperature=act_temp, note_pack=note_pack_bucket(cfg, sub),
            )
            losses.append(float(metrics.loss))
            skipped += int(not metrics.grad_finite)
            if t.log_every > 0 and len(losses) % t.log_every == 0:
                log_fn(f"[epoch {epoch:03d} step {len(losses)}/{steps_per_epoch}] "
                       f"loss={np.mean(losses[-t.log_every:]):.4f}")
            alpha_mean = metrics.alpha_mean
        dt = time.perf_counter() - t0
        if alpha_mean is not None and float(alpha_mean.max()) > 0.95:
            a = alpha_mean.cpu().numpy()
            log_fn(f"[ROUTE HEALTH] collapse alarm: max mean route activation {a.max():.3f} "
                   f"(alpha={np.round(a, 3).tolist()})")

        probs, _, _ = predict_probs(eval_step, state, val_cohort, t.batch_size, m.task)
        val_m = epoch_metrics(np.asarray(val_cohort.y)[: len(probs)], probs)
        monitor = val_m.get("auroc", val_m.get("auroc_macro", 0.0))
        if np.isnan(monitor):
            monitor = 0.0
        row = {"epoch": epoch, "train_loss": float(np.mean(losses)), "val_auroc": float(monitor),
               "lr_scale": lr_scale, "skipped_steps": skipped, "sec": dt}
        history.append(row)
        log_fn(f"[epoch {epoch:03d}] loss={row['train_loss']:.4f} val_auroc={monitor:.4f} "
               f"lr_scale={lr_scale:.3f} ({dt:.1f}s, {skipped} skipped)")

        improved = monitor > best_metric + 1e-6
        if improved:
            best_metric, best_epoch, plateau_count = monitor, epoch, 0
        else:
            plateau_count += 1
            if plateau_count >= t.plateau_patience:
                lr_scale *= t.plateau_factor
                plateau_count = 0
                log_fn(f"[plateau] lr_scale -> {lr_scale:.4f}")
        val_f1 = float(val_m.get("f1", val_m.get("f1_macro", 0.0)))
        improved_f1 = np.isfinite(val_f1) and val_f1 > best_f1 + 1e-6
        if improved_f1:
            best_f1 = val_f1
        state.loop = {
            "sampler": rng.bit_generator.state, "generator": generator.get_state(), "lr_scale": lr_scale,
            "plateau_count": plateau_count, "best_metric": float(best_metric), "best_epoch": best_epoch,
            "best_f1": float(best_f1),
        }
        if ckpt_dir and t.ckpt_every > 0:
            if improved:
                save("best")
            if improved_f1:
                save("best_f1")
            if (epoch + 1) % t.ckpt_every == 0:
                save("last")
        if epoch >= t.min_epochs and epoch - best_epoch >= t.early_stop_patience:
            log_fn(f"[early stop] epoch {epoch}, best {best_metric:.4f} @ {best_epoch}")
            break

    # post-training calibration on the validation split
    probs, _, _ = predict_probs(eval_step, state, val_cohort, t.batch_size, m.task)
    y_val = np.asarray(val_cohort.y)[: len(probs)]
    eps = 1e-7
    logits_val = np.log(np.clip(probs, eps, 1 - eps)) - np.log1p(-np.clip(probs, eps, 1 - eps))
    if y_val.ndim == 1:
        temperature = fit_temperature(logits_val, y_val)
        calibrated = 1 / (1 + np.exp(-logits_val / temperature))
        ths, _ = find_best_thresholds(y_val, calibrated)
        if ckpt_dir:  # reliability diagram of the calibrated validation probabilities
            save_reliability_diagram(y_val, calibrated, ckpt_dir, split="val")
    else:
        temperature = 1.0
        ths, _ = find_best_thresholds(y_val, probs, beta=2.0 if m.task == "pheno" else 1.0)
    if ckpt_dir:
        save("final", temperature=float(temperature), thresholds=ths.ravel())
    return TrainResult(state=state, history=history, best_metric=float(best_metric), thresholds=ths,
                       temperature=float(temperature))
