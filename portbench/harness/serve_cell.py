"""A serving cell: requests of a unit's census (or of a cohort) scored
through ``serve.py:Predictor.predict_records``, offered in an open loop at
the mix's fixed rate.

Set-up makes the weights on the device, writes them with a seeded
temperature and threshold as a checkpoint under ``TMPDIR``
(``ckpt.save_checkpoint``), loads it into a ``Predictor`` (the serving
start-up), makes the pool of host records, and scores one request of every
size the mix sends. In the window request j falls due at j / rate seconds;
the ``Predictor`` serves one request at a time, so a request due while
another is served waits. A request's latency runs from when it was due to
its rows on the host, the wait included; the window holds every request
due in ``--seconds``. With ``--trace 1`` a traced window of
``TRACED_REQUESTS`` requests, sent back to back, follows.

The comparison: a sample of the window's requests drawn from the seed,
with a largest request in it, scored again by the reference
(``portbench/reference/serve.py``) from the same weights, records,
temperature and threshold, in float32 and with the configuration's
bfloat16 rounding. The window keeps the head's logits of every forward (a
forward hook: the device tensors, no copy). Compared (``compare``): the
head's logits, the route priors, the served probabilities against the
program's own logits, the decisions and the top three routes.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from portbench.counts import attention as attn_counts
from portbench.counts import model_flops, peaks
from portbench.harness import traffic, weights as weights_mod
from portbench.reference import model as ref
from portbench.reference.serve import reference_rows, served_probs

TRACED_REQUESTS = 16


def checkpoint_meta(cfg_d: Mapping, seed: int):
    """A seeded calibration: temperature in [0.8, 1.6], thresholds in [0.3, 0.6]."""
    rng = np.random.default_rng([int(seed), 5])
    k = 1 if cfg_d["model"]["task"] == "mort" else cfg_d["model"]["num_classes"]
    return float(rng.uniform(0.8, 1.6)), [float(x) for x in rng.uniform(0.3, 0.6, size=k)]


def row_arrays(rows: List[Dict], routes, logits: Sequence) -> Dict[str, np.ndarray]:
    """What the program's rows say, and the head's logits for those stays
    (one array a forward), as arrays."""
    return {
        "probs": np.array([r["probs"] for r in rows], np.float64),
        "pred": np.array([r["pred"] for r in rows], np.int64),
        "alpha": np.array([[r["alpha"][name] for name in routes] for r in rows], np.float64),
        "top": [list(r["top_routes"]) for r in rows],
        "logits": np.concatenate([np.asarray(lg, np.float64) for lg in logits]),
    }


def run(cell: Mapping, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        hooks: Optional[Mapping[str, Callable]] = None) -> Dict:
    from multimodalrouting_tpu_torch.ckpt import save_checkpoint
    from multimodalrouting_tpu_torch.configs import from_dict
    from multimodalrouting_tpu_torch.serve import Predictor

    hooks = hooks or {}
    cfg_d, mix = cell["config"], cell["traffic"]
    cfg = from_dict(cfg_d)
    w = weights_mod.make_weights(cfg_d, seed, device)
    temperature, thresholds = checkpoint_meta(cfg_d, seed)
    ckpt_dir = tempfile.mkdtemp(prefix="portbench-ckpt-")
    try:
        save_checkpoint(ckpt_dir, w, cfg, temperature=temperature, thresholds=thresholds)
        predictor = Predictor(ckpt_dir, "capsule", device=str(device))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    pool = traffic.make_pool(mix, cfg_d, mix["pool"], seed, device, float_images=True)
    records = traffic.host_records(pool)
    sizes = traffic.request_sizes(mix, seed)
    stays = traffic.request_stays(sizes, len(records), seed)
    score = predictor.predict_records
    if "score" in hooks:  # a planted fault (tests)
        score = hooks["score"](score)
    for s in sorted(set(sizes)):  # every request size once
        score([records[i] for i in stays[sizes.index(s)]])
    # the head's logits of every forward the window runs, kept on the device
    # for the comparison: what the rows' probabilities are calibrated from
    kept: List = []
    hook = predictor.model.register_forward_hook(lambda _m, _i, out: kept.append(out.logits))
    setup_s = time.perf_counter() - t_start

    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    latencies, answers, heads, failed = [], {}, {}, 0
    rate = float(mix["requests_per_s"])
    t0 = time.perf_counter()
    j = 0
    while j / rate < seconds and time.perf_counter() - t0 < seconds:
        if j == len(sizes):
            raise RuntimeError(f"the mix's {len(sizes)} requests ran out before the window closed: raise its blocks")
        due = t0 + j / rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        batch = [records[i] for i in stays[j]]
        try:
            answers[j] = score(batch)
            heads[j] = kept.copy()
        except RuntimeError:
            failed += 1
        kept.clear()
        latencies.append(time.perf_counter() - due)
        j += 1
    t_close = time.perf_counter()
    hook.remove()
    window_s = t_close - t0
    # requests due in the window and still waiting when it closed (above the
    # knee): their latency is at least the wait so far
    waiting = [t_close - (t0 + k / rate) for k in range(j, len(sizes)) if k / rate < seconds]
    latencies += waiting
    n_req = j + len(waiting)
    scored = sum(len(stays[i]) for i in answers)
    peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {
        "metrics": {"setup_s": setup_s, "request_p95_ms": float(np.percentile(np.array(latencies) * 1e3, 95)),
                    "score_stays_per_s": scored / window_s},
        "attempted": n_req, "failed": failed, "memory_peak_bytes": max(setup_peak, peak_window),
        "layer_ctx": {"kind": "serve", "peak_bytes_window": peak_window, "peak_flops": peaks.PEAK_FLOPS["bf16"]},
    }
    if trace:
        from portbench.harness import counters, trace as trace_mod

        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        traced = [stays[(n_req + k) % len(stays)] for k in range(TRACED_REQUESTS)]
        t = trace_mod.traced_window(lambda k: score([records[i] for i in traced[k]]), TRACED_REQUESTS,
                                    counters.launches, sync)
        t["traced_calls"] = TRACED_REQUESTS
        t["k1_bound_ms"] = sum(k1_bound_ms(cfg_d, pool, idx) for idx in traced)
        # requests back to back: their pace is the forward's, where the
        # window's is the offered rate's below the knee
        t["mfu_flops"], t["mfu_s"] = sum(request_flops(cfg_d, pool, idx) for idx in traced), t["window_s"]
        result["layer_ctx"].update(t)

    routes = list(predictor.routes)
    del predictor
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = sample_requests(answers, stays, seed, mix["checked_requests"])
    limits = cell["limits"]
    got = row_arrays([r for i in sample for r in answers[i]], routes,
                     [lg.float().cpu() for i in sample for lg in heads[i]])
    del heads
    recs = [records[s] for i in sample for s in stays[i]]
    with ref.fp32_products():
        want = reference_rows(w, cfg_d, recs, temperature, thresholds, ref.Numerics())
        yard = reference_rows(w, cfg_d, recs, temperature, thresholds, ref.Numerics("bf16"))
    result["checks"] = compare(limits, got, want, yard, routes, thresholds, temperature, cfg_d["model"]["task"])
    return result


def sample_requests(answers: Mapping[int, List], stays, seed: int, n: int) -> List[int]:
    """n answered requests drawn from the seed, the first answered request
    of the most stays among them."""
    done = sorted(answers)
    largest = max(done, key=lambda i: (len(stays[i]), -i))
    rng = np.random.default_rng([int(seed), 6])
    rest = [i for i in done if i != largest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [largest] + sorted(rest[k] for k in pick)


def compare(limits: Mapping, got: Mapping, want: Mapping, yard: Mapping, routes, thresholds, temperature: float,
            task: str) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each beside its limit (a number the limits do
    not name is worked out and left out).

    The head's logits: the root mean square gap from the reference's over
    the sample, over that of `yard`, the reference computed with the
    configuration's bfloat16 rounding, on the same stays (K3's routing by
    agreement amplifies its inputs' rounding by a factor that changes with
    the weights, so an absolute gap swings from seed to seed). The route
    priors (alpha): the widest gap. Each served probability against the
    reference's calibration of the program's own logits, and each decision
    against the reference's rule applied to the served probability (where
    it lies farther from the threshold than the calibration limit). The top
    three routes where the reference's ranks 1 to 4 lie farther apart than
    the alpha limit."""
    head_gap = np.sqrt(((got["logits"] - want["logits"]) ** 2).mean()
                       / max(((yard["logits"] - want["logits"]) ** 2).mean(), 1e-24))
    calibration_gap = np.abs(got["probs"] - served_probs(task, got["logits"], temperature)).max()
    th = np.asarray(thresholds, np.float64)
    th = th if got["probs"].ndim == 2 else th[0]
    clear = np.abs(got["probs"] - th) > limits.get("calibration_gap", 0.0)
    decision_flips = int(((got["pred"] != (got["probs"] >= th)) & clear).sum())
    ranked = np.sort(want["alpha"], axis=1)[:, ::-1]
    # the top three are unambiguous where ranks 1-4 are each farther apart than the limit
    sep = (np.diff(-ranked[:, :4], axis=1) > limits["alpha_gap"]).all(axis=1)
    top_want = [[routes[k] for k in row] for row in want["top"]]
    route_flips = int(sum(1 for g, t, s in zip(got["top"], top_want, sep) if s and g != t))
    values = {"head_gap": head_gap, "alpha_gap": np.abs(got["alpha"] - want["alpha"]).max(),
              "calibration_gap": calibration_gap, "decision_flips": decision_flips, "top_route_flips": route_flips}
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items() if k in limits}


def stay_keys(cfg_d: Mapping, pool: traffic.Pool, i: int) -> List[int]:
    """The valid key count of each of a stay's valid note chunks."""
    length = cfg_d["encoder"]["text_max_len"]
    c = int(pool.chunks[i])
    return [length] * (c - 1) + [int(pool.last_len[i])]


def request_flops(cfg_d: Mapping, pool: traffic.Pool, idx) -> float:
    """The serving forward's useful operations for these stays (valid chunks only)."""
    return sum(model_flops.serve_flops(cfg_d, stay_keys(cfg_d, pool, i)) for i in idx)


def k1_bound_ms(cfg_d: Mapping, pool: traffic.Pool, idx) -> float:
    """The bound of a serving forward's K1 calls: one a BERT layer at
    [stays x chunk slots, T, H] (no packing at serving)."""
    e = cfg_d["encoder"]
    keys = [k for i in idx for k in stay_keys(cfg_d, pool, i)]
    n, t, d = len(idx) * e["notes_max_chunks"], e["text_max_len"], e["bert_hidden"]
    ms, _ = peaks.bound(attn_counts.k1_bytes(n, t, d), attn_counts.k1_flops(keys, t, d), "bf16")
    return e["bert_layers"] * ms
