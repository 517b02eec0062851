"""The epoch-level training loop of every family on one device, or on a
process mesh, over a dense split (counterpart of multimodalrouting_tpu/train/loop.py:32-87 and
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

On a mesh (``train.num_data_shards`` x ``train.num_model_shards`` > 1,
``parallel/mesh.py``; the JAX loop's :169-226) every rank of the process
group runs this loop: the epoch order comes from the same numpy generator on
every rank, which then takes its data shard's rows of each global batch
(and packs its own chunks); the step is the global batch's
(``train/steps.py``); under ``train.zero_sharded_opt`` the moments are
sharded (``parallel/zero.py``); the evaluation gathers every shard's
outputs, so that every rank takes the same plateau, early-stop and
best-checkpoint decisions; rank 0 alone writes checkpoints (full moments)
and the reliability diagram, and the others wait at a barrier. Route
dropout draws from the generator shared by the ranks, in-layer dropout from
one of each data shard's, seeded from (``train.seed``, data shard, epoch):
the ranks of a model group, which hold the same rows, draw the same masks
(each BERT chunk slice its own, ``models/clinbert.py``), and a mesh run at
dropout 0 equals the one-process run.

The 'model' axis takes the role the config names (``parallel/mesh.py:
mesh_role``): chunk sharding by default, tensor parallelism under
``train.tensor_parallel`` (``parallel/tp.py``), route parallelism under
``train.route_parallel`` (``parallel/ep.py``) or the GPipe schedule under
``train.pipeline_parallel`` (``parallel/pp.py``), after the JAX package's
validations (``validate_mesh_config``), which run before any mesh is set.
Under the tensor, route and pipeline roles the state, created or restored
whole, keeps this rank's slices of the sharded parameters, moments and EMA
(``place_state``, before ZeRO-1), and the checkpoints hold the full
tensors, gathered over the model group by every rank and written by rank 0.
Under the pipeline role the validation forwards run the schedule too (each
rank holds its stage's layers only). ``train.microbatch`` > 1 lays each
global batch's rows out so that the step's local microbatches are the
data shard's slices of the JAX step's (``mesh.shard_batch``).

Under ``train.ckpt_backend=orbax_async`` a save gathers and copies the
state to host memory on the loop's thread (on a mesh every rank takes part
in the gather, as for any save), then rank 0 hands the copy to the one
background writer (``ckpt.save_checkpoint(..., background=True)``) and the
loop goes on; the run's end waits for every write on rank 0 before the
ranks' last barrier (``ckpt.wait_for_saves``), as the JAX loop does.
The other backends write before the save returns.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodalrouting_tpu_torch.audit.exports import save_reliability_diagram
from multimodalrouting_tpu_torch.ckpt import TRAIN_STATE, save_checkpoint, wait_for_saves
from multimodalrouting_tpu_torch.configs import Config, to_dict
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to, slice_batch, take_batch
from multimodalrouting_tpu_torch.metrics.calibration import find_best_thresholds, fit_temperature
from multimodalrouting_tpu_torch.metrics.classification import epoch_metrics
from multimodalrouting_tpu_torch.parallel.ep import ep_spec_for_name, validate_ep
from multimodalrouting_tpu_torch.parallel.mesh import (
    host_gather,
    make_mesh,
    mesh_role,
    place_state,
    set_active_mesh,
    shard_batch,
    warmup_collectives,
)
from multimodalrouting_tpu_torch.parallel.pp import pp_spec_for_name, validate_pp
from multimodalrouting_tpu_torch.parallel.tp import local_attention_branch, tp_spec_for_name, validate_tp_divisibility
from multimodalrouting_tpu_torch.parallel.zero import shard_optimizer_state
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


def predict_probs(eval_step, state: TrainState, cohort: Batch, batch_size: int, task: str, mesh=None):
    """Full-split inference in slices of `batch_size` -> (probs, alpha
    [N, R], r_matrix [N, R, K]) on the host; the route audit is None where
    the model gives none. On a `mesh` each slice is padded to a full batch
    by repeating the last row (the JAX loop's clipped gather), each rank
    runs its data shard's rows, and the outputs are gathered over the data
    group, so that every rank holds the whole split's."""
    dev = next(state.model.parameters()).device
    n = cohort.batch_size
    probs, alphas, rms = [], [], []
    for start in range(0, n, batch_size):
        if mesh is None:
            sub, k = slice_batch(cohort, start, batch_size), None
        else:
            sub = shard_batch(take_batch(cohort, np.minimum(np.arange(start, start + batch_size), n - 1)), mesh)
            k = min(batch_size, n - start)
        out = eval_step(state, batch_to(sub, dev))
        probs.append(probs_from_logits(host_gather(out.logits, mesh)[:k], task))
        if out.alpha is not None:
            alphas.append(host_gather(out.alpha, mesh)[:k])
        if out.r_matrix is not None:
            rms.append(host_gather(out.r_matrix, mesh)[:k])
    cat = lambda xs: np.concatenate(xs, 0) if xs else None  # noqa: E731
    return cat(probs), cat(alphas), cat(rms)


# the parameters each weight-sharding role of the 'model' axis splits
ROLE_SPECS = {"tensor": tp_spec_for_name, "route": ep_spec_for_name, "pipeline": pp_spec_for_name}


def validate_mesh_config(cfg: Config) -> None:
    """The JAX package's checks and messages before a mesh run (its loop's
    :169-200), then the port's own: a microbatch that splits over the data
    shards, and no text cache under the pipeline role."""
    t = cfg.train
    if t.batch_size % t.num_data_shards != 0:
        raise ValueError(f"train.batch_size={t.batch_size} must be divisible by "
                         f"train.num_data_shards={t.num_data_shards}")
    if t.tensor_parallel:
        validate_tp_divisibility(cfg, t.num_model_shards)
    if t.pipeline_parallel:
        validate_pp(cfg, t.num_model_shards)
    if t.route_parallel:
        validate_ep(cfg, t.num_model_shards)
    if t.microbatch > 1 and (t.batch_size // t.microbatch) % t.num_data_shards:
        # the JAX step reshards such a microbatch; the port's rows stay where shard_batch put them
        raise ValueError(f"train.microbatch={t.microbatch} cuts train.batch_size={t.batch_size} into microbatches "
                         f"of {t.batch_size // t.microbatch} rows, which do not split over "
                         f"train.num_data_shards={t.num_data_shards}")
    if t.pipeline_parallel and cfg.encoder.text_embedding_cache:
        # the JAX package's cache encoder is layered and cannot read the
        # stacked layers (flax raises ScopeParamNotFoundError); here each
        # stage holds a slice of them
        raise ValueError("encoder.text_embedding_cache does not run under train.pipeline_parallel on a mesh: "
                         "each stage holds only its slice of the BERT layers")


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
    ``ckpt_dir/<best|best_f1|last|final>``.

    With ``train.num_data_shards * train.num_model_shards`` > 1 every rank
    of the process group (``parallel/distributed.init_multihost``) calls
    this with the same arguments: the loop runs on the mesh
    (``parallel/mesh.py``), as described in the module's docstring."""
    t = cfg.train
    mesh = None
    try:
        if t.num_data_shards * t.num_model_shards > 1:
            # the JAX package's checks and messages first, before any global
            # state is set: a refusal must not leave a mesh behind
            validate_mesh_config(cfg)
            mesh = make_mesh(t.num_data_shards, t.num_model_shards, batch_size=t.batch_size, role=mesh_role(cfg))
            warmup_collectives(mesh, next(model.parameters()).device, log_fn=log_fn)
            set_active_mesh(mesh)
        return _train_model(cfg, model, train_cohort, val_cohort, family=family, stage=stage, state=state,
                            log_fn=log_fn, ckpt_dir=ckpt_dir, mesh=mesh)
    finally:
        if mesh is not None:  # the mesh and with it the 'model' axis's role
            set_active_mesh(None)


def _train_model(cfg: Config, model, train_cohort, val_cohort, *, family, stage, state, log_fn, ckpt_dir,
                 mesh) -> TrainResult:
    t, m = cfg.train, cfg.model
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
    rng = np.random.default_rng(t.seed)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(t.seed)
    writer = mesh is None or mesh.rank == 0  # one writer of checkpoints and plots
    if state is None:
        if cfg.encoder.bert_weights or cfg.encoder.vision_weights:
            # a fresh init only, and before the state: its EMA starts from them
            apply_pretrained(cfg, model, log_fn=log_fn)
        state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=n_route_loss_ema_for(cfg, family))
    if mesh is not None and mesh.role in ROLE_SPECS:
        # this rank's slices of the whole state, created or restored
        shards = place_state(state, mesh, ROLE_SPECS[mesh.role])
        log_fn(f"[mesh] {mesh.role} parallelism on data={mesh.n_data},model={mesh.n_model}: "
               f"{len(shards.dims)} parameters sharded over the model group")
        if mesh.role == "pipeline":
            per = cfg.encoder.bert_layers // mesh.n_model
            first = mesh.model_index * per
            log_fn(f"[pp] stage {mesh.model_index} of {mesh.n_model}: BERT layers [{first}, {first + per}) of "
                   f"{cfg.encoder.bert_layers}, GPipe over up to {t.pp_microbatches or mesh.n_model} microbatches "
                   "of the data shard's chunks")
        if mesh.role == "tensor":
            e = cfg.encoder
            branch = local_attention_branch(e.text_max_len, e.bert_hidden, e.bert_heads, mesh.n_model,
                                            frozen=not e.finetune_text)
            log_fn(f"[tp] each rank's BERT attention: {e.bert_heads // mesh.n_model} heads, "
                   f"d={e.bert_hidden // mesh.n_model}, T={e.text_max_len}: the {branch} branch")
    if mesh is not None and t.zero_sharded_opt:
        shard_optimizer_state(state, mesh)
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
        shape = "none" if mesh is None else f"data={mesh.n_data},model={mesh.n_model}"
        log_fn(f"[train] family={family} stage={stage or '-'} n_train={n_train} "
               f"steps/epoch={steps_per_epoch} mesh={shape}")

    background = t.ckpt_backend == "orbax_async"

    def save(name: str, **meta) -> None:
        # under ZeRO, tensor, route or pipeline parallelism every rank takes part in
        # gathering the full tensors; rank 0 alone writes, and the others wait
        t0 = time.perf_counter()
        gathered = state.zero is not None or state.shards is not None
        train_state = train_state_dict(state) if writer or gathered else None
        serving = serving_state_dict(state) if writer or state.shards is not None else None
        if writer:
            def written(path: str, seconds: float) -> None:
                size = os.path.getsize(os.path.join(path, TRAIN_STATE))
                where = " in the background" if background else ""
                log_fn(f"[ckpt] {name}: {TRAIN_STATE} {size} bytes, written in {seconds:.2f}s{where}")

            save_checkpoint(os.path.join(ckpt_dir, name), serving, cfg, train_state=train_state,
                            background=background, on_written=written, **meta)
            log_fn(f"[ckpt] {name}: the loop blocked {time.perf_counter() - t0:.2f}s")
        if mesh is not None:
            dist.barrier()

    lr_scale = 1.0
    best_metric, best_epoch, best_f1 = -np.inf, -1, -np.inf
    plateau_count = 0
    if state.loop:  # a restored state continues its run's schedule
        rng.bit_generator.state = state.loop["sampler"]
        generator.set_state(state.loop["generator"])
        lr_scale, plateau_count = state.loop["lr_scale"], state.loop["plateau_count"]
        best_metric, best_epoch, best_f1 = state.loop["best_metric"], state.loop["best_epoch"], state.loop["best_f1"]
    # on a mesh `generator` (the same on every rank) draws route dropout for
    # the global batch, and in-layer dropout draws from a generator of the
    # data shard's, seeded from (train.seed, data shard, epoch): the ranks of
    # a model group hold the same rows and draw the same masks, as GSPMD
    # draws one mask per row of the global batch
    rank_generator = None
    history: List[Dict[str, float]] = []
    for epoch in range(state.step // steps_per_epoch, t.epochs):
        if mesh is not None:
            seed = int(np.random.SeedSequence((t.seed, mesh.data_index, epoch)).generate_state(1)[0])
            rank_generator = torch.Generator(device=dev).manual_seed(seed)
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
            if mesh is not None:  # this rank's rows (each microbatch's slice); each rank packs its own chunks
                sub = shard_batch(sub, mesh, t.microbatch)
            metrics = train_step(
                state, batch_to(sub, dev), generator if mesh is None else rank_generator, t.lr * lr_scale, lr_enc,
                detach_priors=detach, act_temperature=act_temp, note_pack=note_pack_bucket(cfg, sub),
                route_generator=generator,
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

        probs, _, _ = predict_probs(eval_step, state, val_cohort, t.batch_size, m.task, mesh=mesh)
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
    probs, _, _ = predict_probs(eval_step, state, val_cohort, t.batch_size, m.task, mesh=mesh)
    y_val = np.asarray(val_cohort.y)[: len(probs)]
    eps = 1e-7
    logits_val = np.log(np.clip(probs, eps, 1 - eps)) - np.log1p(-np.clip(probs, eps, 1 - eps))
    if y_val.ndim == 1:
        temperature = fit_temperature(logits_val, y_val)
        calibrated = 1 / (1 + np.exp(-logits_val / temperature))
        ths, _ = find_best_thresholds(y_val, calibrated)
        if ckpt_dir and writer:  # reliability diagram of the calibrated validation probabilities
            save_reliability_diagram(y_val, calibrated, ckpt_dir, split="val")
    else:
        temperature = 1.0
        ths, _ = find_best_thresholds(y_val, probs, beta=2.0 if m.task == "pheno" else 1.0)
    if ckpt_dir:
        save("final", temperature=float(temperature), thresholds=ths.ravel())
        if background:  # no rank returns while a write is in flight
            if writer:
                wait_for_saves()
            if mesh is not None:
                dist.barrier()
    return TrainResult(state=state, history=history, best_metric=float(best_metric), thresholds=ths,
                       temperature=float(temperature))
