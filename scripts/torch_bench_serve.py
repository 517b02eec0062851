"""Serving latency and throughput through the PyTorch port's ``Predictor``
(scripts/bench_serve.py's measurement):

  - single-record request latency (p50 / p95) through
    ``Predictor.predict_records``: record assembly, the forward, calibration
    and the route audit, the whole request path;
  - full-batch scoring throughput (stays/s) through ``Predictor.predict``.

    python3 scripts/torch_bench_serve.py --ckpt runs/flagship [--requests 50]
    python3 scripts/torch_bench_serve.py --artifact runs/flagship_artifact   # artifact.ExportedPredictor
    python3 scripts/torch_bench_serve.py --ckpt runs/tiny --device cpu

The live Predictor warms up through ``Predictor.warmup`` and the artifact
through ``ExportedPredictor.warmup``, so cold start (load_s +
warmup_compile_s: on a card where the kernels are not built yet, their nvcc
build) compares directly. Runs on the card unless given ``--device cpu``;
without a card it exits non-zero. Prints the card's name and power limit,
then one JSON line with bench_serve.py's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench as tb  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--artifact", default=None, help="serve an export_serving_artifact dir (artifact.ExportedPredictor)")
    ap.add_argument("--family", default="capsule")
    ap.add_argument("--name", default="final")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="serving batch (default: the training batch size); "
                         "--batch-size 1 measures the single-record slices")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if bool(args.ckpt) == bool(args.artifact):
        raise SystemExit("pass exactly one of --ckpt or --artifact")
    device = tb.bench_device(args.device)
    card = tb.card_line(device)
    print(f"[env] {tb.device_name(device)}" + (f" ({card})" if card else ""), flush=True)

    from multimodalrouting_tpu_torch.serve import Predictor, batch_from_records

    t0 = time.perf_counter()
    if args.artifact:
        from multimodalrouting_tpu_torch.artifact import ExportedPredictor

        pred = ExportedPredictor(args.artifact, device=args.device)
    else:
        pred = Predictor(args.ckpt, args.family, name=args.name, batch_size=args.batch_size, device=args.device)
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0

    cfg = pred.cfg
    rng = np.random.default_rng(0)
    t, f = cfg.encoder.structured_seq_len, cfg.encoder.structured_n_feats
    synth = cfg.data.synthetic or not cfg.data.data_root
    s = cfg.encoder.notes_max_chunks
    l = min(cfg.encoder.text_max_len, 128) if synth else cfg.encoder.text_max_len  # noqa: E741
    hw = min(cfg.encoder.image_size, 96) if synth else cfg.encoder.image_size

    def record():
        return {
            "x_struct": rng.normal(size=(t, f)).astype(np.float32),
            "note_ids": rng.integers(1, cfg.encoder.bert_vocab_size, size=(s, l)),
            "image": rng.normal(size=(hw, hw, 3)).astype(np.float32),
        }

    # single-record latency: the interactive case (each returns host numpy,
    # so the device has finished when the clock stops)
    lat = []
    for _ in range(args.requests):
        r = record()
        t0 = time.perf_counter()
        pred.predict_records([r])
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3

    # full-batch scoring throughput: the offline case
    full = batch_from_records(cfg, [record() for _ in range(pred.batch_size)])
    pred.predict(full)  # warm this shape
    t0 = time.perf_counter()
    for _ in range(args.batches):
        pred.predict(full)
    dt = time.perf_counter() - t0
    stays_per_sec = pred.batch_size * args.batches / dt

    print(json.dumps({
        "metric": "serving latency/throughput "
                  f"({'ExportedPredictor' if args.artifact else 'Predictor'}, full request path)",
        "load_s": round(load_s, 2),
        "warmup_compile_s": round(warmup_s, 2),
        "request_p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "request_p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
        "batch_scoring_stays_per_sec": round(stays_per_sec, 1),
        "serving_batch": pred.batch_size,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
