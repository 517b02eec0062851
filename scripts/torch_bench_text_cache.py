"""The frozen-BERT note-embedding cache at bench scale, through the PyTorch
port (scripts/bench_text_cache.py's measurement):

  1. direct  the frozen flagship train step with the chunk-BERT forward
  2. cached  the same step with the cohort's ``note_chunk_embs`` computed
             once by ``train/text_cache.attach_note_cache``

plus the one-time cost of building the cache, so that the report shows the
point where the cache pays for itself.

    python3 scripts/torch_bench_text_cache.py                        # on the CUDA card
    python3 scripts/torch_bench_text_cache.py --device cpu --small   # tiny widths on the CPU

Env BENCH_BATCH (16), BENCH_CHUNKS (8), BENCH_STEPS (20), BENCH_WARMUP (3).
The config overrides are that script's own (``overrides``: the dropouts 0,
nothing else), not bench.py's: the model's BERT runs the config's poly GELU
and bf16 LayerNorm, and the cache pass, built from the config without
``encoder.bert_ln`` as in the JAX package, the fp32 LayerNorm. The note pack
of the direct leg is ``note_pack_bucket``'s capacity; the cached leg packs
nothing. Both legs start from one copy of the same initial weights, each
with a fresh train state and the same step generator, and each is closed by
reading back the loss and one element of the first parameter (on the card
that readback waits for the device).

``cache_build_s_incl_compile`` keeps the JAX script's name. There it holds
the cache pass and its XLA compile; here it is the cache pass over the
cohort (one minibatch of ``train.batch_size`` stays at the defaults) with
its copy to the host and back, plus whatever the card sets up on the first
call of that shape (cuBLAS and cuDNN work spaces) and, when build/kernels/
is cold, the nvcc build of the attention kernel. Run it after the kernels
are built (scripts/torch_bench_card.sh does) to read the pass alone.

Earlier lines give the card's name and power limit, and each kernel's
launches in the cache pass and over each leg's timed steps (at the defaults
K1 = 12 in the pass, K1 / K2 / K3 = 12 / 0 / 1 a direct step and 0 / 0 / 1 a
cached one). The last line is the JSON line, under the JAX script's keys.
Without a CUDA card the script exits non-zero unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_bench as tb  # noqa: E402

METRIC = "text-cache train step speedup (10-route trimodal)"


def overrides(batch_size: int) -> dict:
    """scripts/bench_text_cache.py:37-48."""
    return {
        "model.num_classes": 2,
        "model.routes": "10",
        "train.batch_size": batch_size,
        "model.attn_dropout": 0.0,
        "model.relu_dropout": 0.0,
        "model.res_dropout": 0.0,
        "model.embed_dropout": 0.0,
    }


def timed_leg(w: tb.Workload, k: tb.Knobs):
    """`k.warmup` steps of the workload, then `k.steps` timed ones. ->
    (stays/s, the launches over the timed steps, the last timed loss)."""
    metrics = None
    for _ in range(k.warmup):
        metrics = w.step_once()
    if metrics is not None:
        w.force(metrics)
    before = tb.launch_counts()
    t0 = time.perf_counter()
    for _ in range(k.steps):
        metrics = w.step_once()
    w.force(metrics)
    dt = time.perf_counter() - t0
    return k.batch * k.steps / dt, tb.counts_since(before), float(metrics.loss)


def run_text_cache(k: tb.Knobs, device, extra=None) -> dict:
    """The cache build and both legs. -> the JSON line (``line``), the
    launches of the cache pass and of each leg's timed steps (``launches``)
    and each leg's last loss (``losses``)."""
    from multimodalrouting_tpu_torch.data.batches import batch_to
    from multimodalrouting_tpu_torch.train.state import create_train_state
    from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache

    w = tb.build_workload(overrides(k.batch), k, device, extra)
    init = {name: t.detach().clone() for name, t in w.model.state_dict().items()}
    dev = w.batch.x_struct.device

    before = tb.launch_counts()
    t0 = time.perf_counter()
    cached_batch = batch_to(attach_note_cache(w.cfg, w.model, w.cohort), dev)
    float(cached_batch.note_chunk_embs.reshape(-1)[0])
    build_s = time.perf_counter() - t0
    launches = {"cache_build": tb.counts_since(before)}

    rates, losses, pack = {}, {}, w.cap
    for leg, batch, cap in (("direct", w.batch, pack), ("cached", cached_batch, 0)):
        w.model.load_state_dict(init)
        w.state = create_train_state(w.cfg, w.model)
        w.batch, w.cap = batch, cap
        w.generator = torch.Generator(device=dev).manual_seed(w.cfg.train.seed)
        rates[leg], launches[leg], losses[leg] = timed_leg(w, k)
    e = w.cfg.encoder
    tb.log(f"[text_cache] note pack: capacity {pack} of {w.cohort.chunk_mask.size} chunk slots (direct leg); "
           f"GELU {e.bert_gelu}, LN {e.bert_ln} in the model, fp32 in the cache pass; batch {k.batch}")
    tb.log(f"[text_cache] launches: cache pass {json.dumps(launches['cache_build'])}; over {k.steps} timed steps "
           f"direct {json.dumps(launches['direct'])}, cached {json.dumps(launches['cached'])}; expected K1 "
           f"{e.bert_layers} a pass of {k.batch} stays, per step direct K1 {e.bert_layers}, K3 1, cached K3 1")
    tb.log(f"[text_cache] last timed loss direct={losses['direct']:.6f} cached={losses['cached']:.6f}")
    line = {
        "metric": METRIC,
        "direct_stays_per_sec": round(rates["direct"], 3),
        "cached_stays_per_sec": round(rates["cached"], 3),
        "speedup": round(rates["cached"] / rates["direct"], 2),
        "cache_build_s_incl_compile": round(build_s, 2),
        "batch": k.batch, "chunks": k.chunks, "steps": k.steps,
    }
    return {"line": line, "launches": launches, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="tiny widths for the CPU")
    args = ap.parse_args(argv)
    device = tb.bench_device(args.device)
    tb.log_environment(device)
    out = run_text_cache(tb.knobs(), device, tb.SMALL if args.small else None)
    tb.log(json.dumps(out["line"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
