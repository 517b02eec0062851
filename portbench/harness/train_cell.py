"""A training cell: the port's capsule train step over a seeded pool.

Set-up makes the weights and the pool on the device, builds the model
(``models/full.py:build_model``), its train state
(``train/state.py:create_train_state``) and step
(``train/steps.py:make_train_step``) once, and drives that same step
through its first three batches (read for the comparison) and through one
batch of every pack capacity the window will meet. The window then calls
the step on the pool's batches in order, cyclically, for ``--seconds``,
closed by reading back the loss and a parameter. With ``--trace 1`` a
traced window of ``TRACED_STEPS`` steps follows.

The comparison: the reference (``portbench/reference/train.py``) trains
from the same weights on the same three batches. Worked out are each step's
loss, each trainable leaf's gradient norm as the optimizer got it at step 1
(Adam's first moment after one step over 1 - b1), and each leaf's change
over the three steps as step 4 finds the parameters (``compare``); the
cell's limits file names the numbers that are compared.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from portbench.counts import attention as attn_counts
from portbench.counts import model_flops, peaks
from portbench.harness import traffic, weights as weights_mod
from portbench.reference import model as ref
from portbench.reference.train import ADAM_B1, reference_steps

TRACED_STEPS = 6
COMPARED_STEPS = 3
# leaves whose reference gradient is below this share of the median leaf's
# move by round-off under Adam (a key's bias under softmax): their change
# is not compared
CHANGE_FLOOR = 1e-3


def batch_fields(pool: traffic.Pool, idx: np.ndarray) -> Dict[str, torch.Tensor]:
    sel = torch.as_tensor(idx, device=pool.fields["y"].device)
    return {k: v.index_select(0, sel) for k, v in pool.fields.items()}


def to_batch(fields: Mapping[str, torch.Tensor]):
    from multimodalrouting_tpu_torch.data.batches import Batch

    return Batch(**{k: fields[k] for k in ("x_struct", "m_struct", "note_ids", "note_attn", "chunk_mask", "image",
                                           "has_l", "has_n", "has_i", "y")})


def pack_capacity(cfg, chunk_mask: torch.Tensor) -> int:
    """The train loop's chunk-pack capacity of a batch (``note_pack_bucket``)."""
    from multimodalrouting_tpu_torch.data.batches import Batch
    from multimodalrouting_tpu_torch.train.loop import note_pack_bucket

    host = Batch(*([None] * 4), chunk_mask=chunk_mask.cpu().numpy(), image=None, has_l=None, has_n=None,
                 has_i=None, y=None)
    return note_pack_bucket(cfg, host)


def leaf_gaps(prog: Mapping[str, float], refv: Mapping[str, float], names) -> List[float]:
    """Each leaf's gap between the two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(refv[n] for n in names)
    return [abs(prog[n] - refv[n]) / max(refv[n], med) for n in names]


def run(cell: Mapping, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        hooks: Optional[Mapping[str, Callable]] = None) -> Dict:
    from multimodalrouting_tpu_torch.configs import from_dict
    from multimodalrouting_tpu_torch.models.full import build_model
    from multimodalrouting_tpu_torch.train.state import create_train_state
    from multimodalrouting_tpu_torch.train.steps import make_train_step

    hooks = hooks or {}
    cfg_d, mix = cell["config"], cell["traffic"]
    cfg = from_dict(cfg_d)
    w = weights_mod.make_weights(cfg_d, seed, device)
    pool = traffic.make_pool(mix, cfg_d, mix["batch"] * mix["pool_batches"], seed, device)
    order = traffic.train_order(mix, pool.labels, seed)
    batches = [to_batch(batch_fields(pool, idx)) for idx in order]
    caps = [pack_capacity(cfg, b.chunk_mask) for b in batches]
    with torch.device(device):
        model = build_model(cfg, "capsule", device=device, train=True)
    model.load_state_dict(w, strict=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "capsule")
    if "step" in hooks:  # a planted fault (tests)
        step = hooks["step"](step)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lr, lr_enc = cfg.train.lr, cfg.train.encoder_lr

    def call(i: int):
        j = i % len(batches)
        return step(state, batches[j], gen, lr, lr_enc, note_pack=caps[j])

    def force(metrics) -> float:
        return float(metrics.loss) + float(state.params()[0].detach().reshape(-1)[0])

    # the compared steps, through the window's own call
    losses, grad_norms = [], {}
    for i in range(COMPARED_STEPS):
        m = call(i)
        losses.append(float(m.loss))
        if i == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(state.mu[n].float())) / (1.0 - ADAM_B1)
                          for n in state.names}
    named = dict(model.named_parameters())
    change_norms = {n: float(torch.linalg.vector_norm(named[n].detach().float() - w[n])) for n in state.names}
    # one step at every pack capacity not met yet, so that the window meets no new shape
    seen = set(caps[:COMPARED_STEPS])
    for j, c in enumerate(caps):
        if c not in seen:
            seen.add(c)
            force(call(j))
    force(call(COMPARED_STEPS))
    batch_flops = [batch_train_flops(cfg_d, b) for b in batches]
    setup_s = time.perf_counter() - t_start

    # the measured window
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    i0, n, failed = COMPARED_STEPS + 1, 0, 0
    t0 = time.perf_counter()
    m = None
    while time.perf_counter() - t0 < seconds:
        m = call(i0 + n)
        failed += 0 if m.grad_finite else 1
        n += 1
    force(m)
    window_s = time.perf_counter() - t0
    stays = n * mix["batch"]
    flops = sum(batch_flops[(i0 + i) % len(batches)] for i in range(n))
    peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    memory_peak = max(setup_peak, peak_window)
    result = {
        "metrics": {"setup_s": setup_s, "train_stays_per_s": stays / window_s},
        "attempted": n, "failed": failed, "memory_peak_bytes": memory_peak,
        "layer_ctx": {"kind": "train", "mfu_s": window_s, "mfu_flops": flops, "peak_bytes_window": peak_window,
                      "peak_flops": peaks.PEAK_FLOPS["bf16"]},
    }
    if trace:
        from portbench.harness import counters, trace as trace_mod

        start = i0 + n
        t = trace_mod.traced_window(lambda k: call(start + k), TRACED_STEPS, counters.launches, sync)
        traced = [batches[(start + k) % len(batches)] for k in range(TRACED_STEPS)]
        t["traced_calls"] = TRACED_STEPS
        t["k1_bound_ms"] = sum(k1_bound_ms(cfg_d, b, caps[(start + k) % len(batches)]) for k, b in enumerate(traced))
        if cfg_d["encoder"]["finetune_text"]:
            t["k2_bound_ms"] = sum(k2_bound_ms(cfg_d, b, caps[(start + k) % len(batches)])
                                   for k, b in enumerate(traced))
        result["layer_ctx"].update(t)

    # the program's state is freed before the reference runs
    compared_batches = [{k: v for k, v in b._asdict().items() if v is not None} for b in batches[:COMPARED_STEPS]]
    del state, model, step, named, batches, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with ref.fp32_products():
        r = reference_steps(w, cfg_d, compared_batches, ref.Numerics())
    result["checks"] = compare(cell["limits"], losses, grad_norms, change_norms, r)
    return result


def compare(limits: Mapping, losses: List[float], grad_norms: Mapping[str, float],
            change_norms: Mapping[str, float], r: Mapping) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each beside its limit; a number the limits do
    not name is worked out and left out (see PERF.md for why)."""
    rl, rg, rc = r["losses"], r["grad_norms"], r["change_norms"]
    med = statistics.median(rg.values())
    moving = [n for n in rg if rg[n] >= CHANGE_FLOOR * med]
    grads = leaf_gaps(grad_norms, rg, list(rg))
    values = {
        "loss_gap": abs(losses[0] - rl[0]) / abs(rl[0]),  # the first step's loss
        "grad_gap": statistics.median(grads),  # the median leaf's
        "change_gap": statistics.median(leaf_gaps(change_norms, rc, moving)),  # the median moving leaf's
        "change_gap_worst": max(leaf_gaps(change_norms, rc, moving)),
        "later_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses[1:], rl[1:])),
        "grad_gap_worst": max(grads),
    }
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items() if k in limits}


def batch_train_flops(cfg_d: Mapping, batch) -> float:
    keys = ref.chunk_valid_keys({"chunk_mask": batch.chunk_mask, "note_attn": batch.note_attn})
    cm = batch.chunk_mask.cpu().numpy() > 0.5
    keys = keys.cpu().numpy().tolist()
    total, at = 0.0, 0
    for row in cm:
        c = int(row.sum())
        total += model_flops.train_flops(cfg_d, keys[at:at + c])
        at += c
    return total


def k1_bound_ms(cfg_d: Mapping, batch, cap: int) -> float:
    """The bound of the step's K1 calls: one a BERT layer at [cap, T, H],
    over the valid keys of the packed chunks."""
    e = cfg_d["encoder"]
    keys = ref.chunk_valid_keys({"chunk_mask": batch.chunk_mask, "note_attn": batch.note_attn}).cpu().tolist()
    n, t, d = cap or batch.chunk_mask.numel(), e["text_max_len"], e["bert_hidden"]
    ms, _ = peaks.bound(attn_counts.k1_bytes(n, t, d), attn_counts.k1_flops(keys, t, d), "bf16")
    return e["bert_layers"] * ms


def k2_bound_ms(cfg_d: Mapping, batch, cap: int) -> float:
    e = cfg_d["encoder"]
    keys = ref.chunk_valid_keys({"chunk_mask": batch.chunk_mask, "note_attn": batch.note_attn}).cpu().tolist()
    n, t, d = cap or batch.chunk_mask.numel(), e["text_max_len"], e["bert_hidden"]
    ms, _ = peaks.bound(attn_counts.k2_bytes(n, t, d, e["bert_heads"]), attn_counts.k2_flops(keys, t, d), "bf16")
    return e["bert_layers"] * ms
