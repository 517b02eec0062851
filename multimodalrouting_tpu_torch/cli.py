"""Command-line entry point of the port (counterpart of multimodalrouting_tpu/cli.py):

  python -m multimodalrouting_tpu_torch.cli train --family capsule --task mort \\
      --routes 10 --out runs/capsule       # the flagship (MortModel/Paired_Cross_Attention)
  python -m multimodalrouting_tpu_torch.cli train --family capsule --task pheno \\
      --routes 7 --set model.bi_fusion_mode=linear   # PhenoModel/main.py
  python -m multimodalrouting_tpu_torch.cli train --family gated_concat \\
      --stage step1|step2|step3 [--init-from DIR]    # Model/train_step{1,2,3}
  python -m multimodalrouting_tpu_torch.cli train --family fame \\
      --stage uni|bi|tri [--init-from DIR]           # train_fame.py curriculum
  python -m multimodalrouting_tpu_torch.cli train --family late_fusion|trimf
  python -m multimodalrouting_tpu_torch.cli train --task pheno --routes 10 \\
      --config configs/pheno_atten_mult.yaml         # PhenoModel attention family
  python -m multimodalrouting_tpu_torch.cli train ... --resume runs/capsule --epochs 12
  python -m multimodalrouting_tpu_torch.cli eval --ckpt runs/capsule --drop-table [--family F]
  python -m multimodalrouting_tpu_torch.cli predict --ckpt runs/capsule --split test [--family F]
  python -m multimodalrouting_tpu_torch.cli predict --ckpt runs/capsule --export-artifact art [--platforms cpu,cuda]
  python -m multimodalrouting_tpu_torch.cli predict --artifact art --split test
  python -m multimodalrouting_tpu_torch.cli interpret --ckpt runs/gated --out-csv sweep.csv
  python -m multimodalrouting_tpu_torch.cli unimodal --modality behrt|note|omop|ct \\
      [--task multitask|readmit] [--stratify auto|on|off]   # 01_BEHRT.py, 02_BEHRT.py,
                                     # 01_BioClinicalBert.py, INSPECT's OMOP and CT trainers
  python -m multimodalrouting_tpu_torch.cli unimodal --modality note --impressions-csv imp.csv [--vocab vocab.txt]
  python -m multimodalrouting_tpu_torch.cli unimodal --modality omop --inspect-csv final_structured_dataset.csv
  python -m multimodalrouting_tpu_torch.cli etl varmap|cohort|export|medfuse|inspect|legacy ...

The baselines (late_fusion, trimf) train under the fame loss family, and
``eval`` writes the route heatmap tables only for a family with alpha and an
R-matrix (the capsule family), as the JAX CLI does.

The parser is the JAX package's: the same subcommands, flags, defaults and
choices, plus ``--device {cuda,cpu}`` on ``train``, ``unimodal``, ``eval``,
``predict`` and ``interpret`` (default ``cuda``; the JAX package picks its
device by ``JAX_PLATFORMS``).
Without a card, ``--device cuda`` raises; nothing falls back to the CPU.

Checkpoints: the port writes the directory ``<dir>/<name>/`` (``config.json``,
``meta.json``, ``weights.pt``, ``train_state.pt``; ``ckpt.py``); the JAX
package writes ``<dir>/<name>.msgpack`` with ``<dir>/<name>.meta.json``.
``--ckpt DIR --name NAME``, ``--resume DIR`` (name ``last``) and
``--init-from DIR --init-name NAME`` read either (``ckpt.resolve``), so a
run trained with the JAX package serves, evaluates and resumes here; an
orbax checkpoint (``<dir>/<name>.orbax/``) raises.

``predict --export-artifact DIR`` writes a checkpoint's serving artifact (a
``torch.export`` program with the kernels as custom ops, ``artifact.py``)
and ``predict --artifact DIR`` serves one; ``interpret`` runs the gated
family's occlusion and UC/BI/TI sweep (``audit/sweep.py``).

``etl`` takes a raw MIMIC-style csv.gz dump through ``varmap``, ``cohort``
and ``export`` to the parquet model inputs (``data/``) that ``train``,
``eval``, ``predict`` and ``unimodal`` read with ``data.synthetic=false
data.data_root=EXPORT`` (images under ``data.image_root``; the train split
streamed under ``data.stream=true``); ``predict`` writes each row's
``stay_id``. ``etl medfuse | inspect | legacy`` are the other cohorts' ETLs,
and ``unimodal --impressions-csv`` / ``--inspect-csv`` their INSPECT
loaders. ``encoder.text_embedding_cache=true`` runs the frozen BERT body
once per split (``train/text_cache.py``) in ``train`` and ``eval``.

What the port does not have yet raises ``NotImplementedError`` naming its
ROADMAP.md item, and never runs another path in its place: device meshes
and multi-host runs (item 12).

Config resolution is the JAX package's: defaults <- --config file <-
MIMICIV_* env vars <- --set key=value overrides.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

FAMILIES = ["capsule", "gated_concat", "fame", "late_fusion", "trimf"]
# the JAX package's multi-host triggers (parallel/distributed.py:init_multihost)
MULTIHOST_ENV = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §1 item {item})")


def _parse_sets(pairs: List[str]) -> Dict[str, str]:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _check_cfg(cfg, family: str) -> None:
    """Refuse the configurations the port does not run."""
    if cfg.train.num_data_shards * cfg.train.num_model_shards > 1:
        raise _not_ported("a multi-device --mesh", "12")


SPLITS = ("train", "val", "test")


def _synthetic(cfg) -> bool:
    return cfg.data.synthetic or not cfg.data.data_root


def _synthetic_split(cfg, task: str, split: str):
    """A synthetic cohort of ``data.synthetic_n`` stays, seed 0 / 1 / 2 for
    train / val / test, notes clipped to 128 tokens and images to 96^2 as
    the JAX CLI clips them."""
    from multimodalrouting_tpu_torch.data.synthetic import make_synthetic_cohort

    n, e = cfg.data.synthetic_n, cfg.encoder
    return make_synthetic_cohort(
        n,
        t=e.structured_seq_len,
        f=e.structured_n_feats,
        s=e.notes_max_chunks,
        l=min(e.text_max_len, 128),
        image_size=min(e.image_size, 96),
        vocab_size=e.bert_vocab_size,
        pos_rate=cfg.data.synthetic_pos_rate,
        missing_rate=cfg.data.synthetic_missing_rate,
        seed=SPLITS.index(split),
        task=task,
    )


def _image_loading(cfg, split: str):
    """(image_loader, image_dtype) of a real export's split: the augmenting
    transform stack for train, the deterministic one for val and test
    (reference build_image_transform(split), main.py:907-925), uint8 pixels
    under ``encoder.image_uint8_transfer``."""
    from multimodalrouting_tpu_torch.data.images import make_image_loader

    e = cfg.encoder
    pixels = "uint8" if e.image_uint8_transfer else "normalized"
    loader = make_image_loader(split, spec=e.image_transform, resize=e.image_resize, crop=e.image_size,
                               seed=cfg.train.seed, root=cfg.data.image_root, pixels=pixels)
    return loader, (np.uint8 if pixels == "uint8" else np.float32)


def _load_split(cfg, task: str, split: str):
    """One split as a host ``Batch`` and its stay ids: a synthetic cohort
    (no ids), or the split of the export under ``data.data_root``."""
    from multimodalrouting_tpu_torch.data.loader import load_split

    if split not in SPLITS:
        raise SystemExit(f"--split must be train|val|test, got {split!r}")
    if _synthetic(cfg):
        return _synthetic_split(cfg, task, split), None
    loader, dtype = _image_loading(cfg, split)
    arrays = load_split(cfg.data.data_root, split, task=task, image_size=cfg.encoder.image_size,
                        image_loader=loader, image_dtype=dtype)
    return arrays.batch, arrays.stay_ids


def _load_data(cfg, task: str, splits=SPLITS):
    """The host ``Batch`` of each of `splits` (train, val, test by default):
    synthetic cohorts, or the export under ``data.data_root`` with the train
    split streamed (``StreamingSplit``) under ``data.stream`` while val and
    test stay dense, as the JAX CLI loads them."""

    def one(split):
        if split != "train" or _synthetic(cfg) or not cfg.data.stream:
            return _load_split(cfg, task, split)[0]
        from multimodalrouting_tpu_torch.data.streaming import StreamingSplit

        loader, dtype = _image_loading(cfg, "train")
        return StreamingSplit(cfg.data.data_root, "train", task=task, image_size=cfg.encoder.image_size,
                              image_loader=loader, image_dtype=dtype,
                              rows_per_read=cfg.data.stream_rows_per_read,
                              shuffle_buffer=cfg.data.stream_shuffle_buffer, seed=cfg.train.seed)

    return tuple(one(split) for split in splits)


def cmd_train(args) -> int:
    import torch

    from multimodalrouting_tpu_torch.ckpt import restore_train_state
    from multimodalrouting_tpu_torch.configs import load_cfg
    from multimodalrouting_tpu_torch.models.full import build_model
    from multimodalrouting_tpu_torch.train.loop import train_model
    from multimodalrouting_tpu_torch.train.state import create_train_state, n_route_loss_ema_for
    from multimodalrouting_tpu_torch.train.steps import loss_family
    from multimodalrouting_tpu_torch.utils.profiling import trace_context

    if any(os.environ.get(k) for k in MULTIHOST_ENV):
        raise _not_ported("a multi-host run", "12")
    overrides = _parse_sets(args.set or [])
    if args.task:
        overrides.setdefault("model.task", args.task)
        if args.task == "pheno":
            overrides.setdefault("model.num_classes", "25")
        elif args.task == "mort":
            overrides.setdefault("model.num_classes", "2")
        elif args.task == "multitask":
            overrides.setdefault("model.num_classes", "3")
    if args.routes:
        overrides.setdefault("model.routes", args.routes)
    if args.epochs is not None:
        overrides["train.epochs"] = str(args.epochs)
    if args.mesh:
        for part in args.mesh.split(","):
            axis, _, n = part.partition("=")
            axis = axis.strip()
            if axis not in ("data", "model") or not n.strip().isdigit():
                raise SystemExit(f"--mesh: bad spec {part!r} (want data=N[,model=M])")
            key = "num_data_shards" if axis == "data" else "num_model_shards"
            overrides[f"train.{key}"] = n.strip()
    cfg = load_cfg(args.config, overrides)
    _check_cfg(cfg, args.family)

    train_b, val_b = _load_data(cfg, cfg.model.task, splits=("train", "val"))
    family = loss_family(args.family)
    stage = args.stage or ""
    torch.manual_seed(cfg.train.seed)
    model = build_model(cfg, args.family, device=args.device, train=True)
    out_dir = args.out or os.path.join(cfg.out_dir, args.family)
    os.makedirs(out_dir, exist_ok=True)

    state = None
    if args.init_from or args.resume:
        # --resume: full restore (moments, step, schedule); --init-from: stage
        # chaining (weights and EMA, fresh optimizer)
        state = create_train_state(cfg, model, stage=stage, n_route_loss_ema=n_route_loss_ema_for(cfg, family))
        if args.resume:
            state = restore_train_state(args.resume, state, name="last")
            print(f"[resume] {args.resume}/last at step {state.step}")
        else:
            state = restore_train_state(args.init_from, state, name=args.init_name, params_only=True)

    with trace_context(args.profile_dir, cuda=args.device == "cuda"):
        result = train_model(cfg, model, train_b, val_b, family=family, stage=stage, state=state,
                             ckpt_dir=out_dir)
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(result.history, f, indent=2)
    print(
        json.dumps(
            {
                "family": args.family,
                "stage": stage,
                "best_val_auroc": result.best_metric,
                "temperature": result.temperature,
                "epochs_ran": len(result.history),
                "ckpt_dir": out_dir,
            }
        )
    )
    return 0


def cmd_eval(args) -> int:
    from multimodalrouting_tpu_torch.audit.droptable import drop_table_eval, format_drop_table
    from multimodalrouting_tpu_torch.audit.exports import routing_heatmap_tables, save_reliability_diagram
    from multimodalrouting_tpu_torch.ckpt import load_config, load_meta, restore_train_state
    from multimodalrouting_tpu_torch.data.batches import Batch, slice_batch
    from multimodalrouting_tpu_torch.metrics.calibration import expected_calibration_error
    from multimodalrouting_tpu_torch.metrics.classification import epoch_metrics
    from multimodalrouting_tpu_torch.metrics.fairness import eddi, equalized_odds_gap, predictive_parity_gap
    from multimodalrouting_tpu_torch.models.full import build_model
    from multimodalrouting_tpu_torch.routes import get_routes
    from multimodalrouting_tpu_torch.serve import calibrate_probs
    from multimodalrouting_tpu_torch.train.loop import predict_probs
    from multimodalrouting_tpu_torch.train.state import create_train_state, n_route_loss_ema_for
    from multimodalrouting_tpu_torch.train.steps import loss_family, make_eval_step
    from multimodalrouting_tpu_torch.train.text_cache import attach_note_cache

    cfg = load_config(args.ckpt, args.name)
    _check_cfg(cfg, args.family)
    test_b, _ = _load_split(cfg, cfg.model.task, "test")
    model = build_model(cfg, args.family, device=args.device)
    family = loss_family(args.family)
    # eval reads the weights, their EMA and the route-loss EMA, not the
    # optimizer: a checkpoint of any curriculum stage evaluates
    state = create_train_state(cfg, model, n_route_loss_ema=n_route_loss_ema_for(cfg, family))
    state = restore_train_state(args.ckpt, state, name=args.name, params_only=True)
    if cfg.encoder.text_embedding_cache and not cfg.encoder.finetune_text:
        # one BERT pass over the split: every batch after it, each drop-table
        # condition too (they act on the has_* flags only), skips the body
        test_b = attach_note_cache(cfg, model, test_b)
    eval_step = make_eval_step(cfg, model, family)
    bs = cfg.train.batch_size
    probs, alpha, r_matrix = predict_probs(eval_step, state, test_b, bs, cfg.model.task)
    y = np.asarray(test_b.y)[: len(probs)]

    # apply the validation-fitted temperature and thresholds saved with the checkpoint
    meta = load_meta(args.ckpt, args.name)
    temperature = float(meta.get("temperature", 1.0) or 1.0)
    probs = calibrate_probs(probs, temperature)
    thresholds = meta.get("thresholds")
    th_arr = np.asarray(thresholds, np.float64) if thresholds else None

    metrics = epoch_metrics(y, probs, thresholds=th_arr if y.ndim == 2 else None,
                            threshold=float(th_arr[0]) if (th_arr is not None and y.ndim == 1) else 0.5)
    metrics["temperature"] = temperature
    if y.ndim == 1:
        metrics["ece"] = expected_calibration_error(y, probs)
    if test_b.sens is not None and y.ndim == 1:
        s = np.asarray(test_b.sens)[: len(probs)]
        th = float(th_arr[0]) if th_arr is not None else 0.5
        metrics["eddi"] = eddi(y, probs, s)
        metrics.update(equalized_odds_gap(y, probs >= th, s))
        metrics["ppv_gap"] = predictive_parity_gap(y, probs >= th, s)
    print(json.dumps({k: v for k, v in metrics.items() if not isinstance(v, list)}, indent=2))

    out_dir = args.out or args.ckpt
    if y.ndim == 1:
        save_reliability_diagram(y, probs, out_dir, split="test")
    if alpha is not None and r_matrix is not None:
        routing_heatmap_tables(alpha, r_matrix, get_routes(cfg.model.routes), out_dir, split="test")
        print(f"[audit] route heatmaps/tables -> {out_dir}")

    if args.drop_table:
        def predict(b: Batch):
            p, _, _ = predict_probs(eval_step, state, b, bs, cfg.model.task)
            return calibrate_probs(p, temperature)

        # whole batches only, as the JAX CLI trims; a split smaller than one
        # batch is kept whole
        n_full = (test_b.batch_size // bs) * bs or test_b.batch_size
        print(format_drop_table(drop_table_eval(predict, slice_batch(test_b, 0, n_full), thresholds=th_arr)))
    return 0


def cmd_predict(args) -> int:
    """Serving path: checkpoint or serving artifact -> calibrated predictions
    (JSONL or HTTP), with the validation-fitted temperature and thresholds
    and the route audit per prediction (``serve.py``); ``--export-artifact``
    writes a checkpoint's serving artifact (``artifact.py``) and exits."""
    from multimodalrouting_tpu_torch.ckpt import load_config
    from multimodalrouting_tpu_torch.serve import Predictor, make_http_server, write_predictions_jsonl

    if args.artifact and args.ckpt:
        raise SystemExit("pass either --ckpt or --artifact, not both")
    if args.artifact:
        from multimodalrouting_tpu_torch.artifact import ExportedPredictor

        if args.export_artifact:
            raise SystemExit("--export-artifact needs --ckpt (a live Predictor)")
        pred = ExportedPredictor(args.artifact, device=args.device)
        _check_cfg(pred.cfg, pred.family)
    else:
        if not args.ckpt:
            raise SystemExit("one of --ckpt or --artifact is required")
        _check_cfg(load_config(args.ckpt, args.name), args.family)
        pred = Predictor(args.ckpt, args.family, name=args.name, batch_size=args.batch_size, device=args.device)

    if args.export_artifact:
        from multimodalrouting_tpu_torch.artifact import export_serving_artifact

        platforms = args.platforms.split(",") if args.platforms else None
        out = export_serving_artifact(pred, args.export_artifact, platforms=platforms)
        print(json.dumps({"artifact": out, "platforms": platforms or [pred.device.type]}))
        return 0

    if args.port is not None:
        server = make_http_server(pred, port=args.port)
        host, port = server.server_address[:2]
        print(f"[serve] http://{host}:{port}  POST /predict  GET /health", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        finally:
            server.server_close()
        return 0

    # a real export's split decodes its images with the deterministic eval
    # stack (any split but train), the pixels its val / test metrics saw
    cohort, stay_ids = _load_split(pred.cfg, pred.cfg.model.task, args.split)
    out_path = args.out or os.path.join(args.ckpt or args.artifact, f"predictions_{args.split}.jsonl")
    n = write_predictions_jsonl(pred, cohort, out_path, stay_ids=stay_ids)
    print(json.dumps({"rows": n, "out": out_path, "temperature": pred.temperature}))
    return 0


def _print_unimodal(modality: str, res, out_dir: str) -> None:
    print(json.dumps({
        "modality": modality,
        "tasks": list(res.metrics),
        "auroc": {k: float(v.get("auroc", float("nan"))) for k, v in res.metrics.items()},
        "out_dir": out_dir,
    }))


def _unimodal_cfg(args):
    from multimodalrouting_tpu_torch.configs import load_cfg

    overrides = _parse_sets(args.set or [])
    if args.epochs is not None:
        overrides["train.epochs"] = str(args.epochs)
    if args.task and args.modality in ("behrt", "note"):
        overrides["model.task"] = {"readmit": "mort"}.get(args.task, args.task)
    return load_cfg(args.config, overrides)


def cmd_unimodal(args) -> int:
    """The unimodal trainers and their fairness report (01_BEHRT.py,
    02_BEHRT.py, 01_BioClinicalBert.py, INSPECT/BEHRT.py, INSPECT's CT
    branch) on the synthetic cohorts or a real export; ``--impressions-csv``
    runs INSPECT's text-only multitask trainer (INSPECT/BioClinicalBERT.py)
    on the tasks the CSV's label columns name."""
    from multimodalrouting_tpu_torch.train.unimodal import train_unimodal

    if args.modality in ("omop", "ct"):
        return _cmd_unimodal_inspect(args)
    cfg = _unimodal_cfg(args)
    if cfg.data.stream:
        raise SystemExit("unimodal trainers need dense splits; unset data.stream")
    tasks = None
    if args.impressions_csv:
        # impressions CSV -> per-patient note Batches with age-bucket fairness
        # groups; the label columns found in the CSV are the tasks
        if args.modality != "note":
            raise SystemExit("--impressions-csv requires --modality note")
        from multimodalrouting_tpu_torch.data.inspect_etl import load_impressions_dataset

        e = cfg.encoder
        splits = load_impressions_dataset(args.impressions_csv, max_len=e.text_max_len, stride=args.stride,
                                          max_chunks=e.notes_max_chunks, tokenizer_name=e.text_model_name,
                                          vocab_path=args.vocab, seed=cfg.train.seed)
        train_b, val_b, test_b = splits["train"], splits["val"], splits["test"]
        tasks = splits["_tasks"]
        data_task = args.task or "multitask"
        stratify = False
    else:
        _check_cfg(cfg, "")
        # multitask labels (mortality / pe / ph) ride the synthetic "multitask"
        # y; readmit is a binary label column in real exports
        data_task = args.task or cfg.model.task
        train_b, val_b, test_b = _load_data(cfg, data_task)
        # the wide-BEHRT multitask trainer's split protocol: multilabel-stratified
        # 20% test, then 5/80 of the rest as val, over the pooled splits
        # (Unimodal/MIMIC/BEHRT.py:228-232); on by default for behrt + multitask
        stratify = (args.modality == "behrt" and data_task == "multitask" if args.stratify == "auto"
                    else args.stratify == "on")
    if stratify:
        from multimodalrouting_tpu_torch.data.batches import concat_batches, take_batch
        from multimodalrouting_tpu_torch.data.stratified import stratified_three_way

        pooled = concat_batches([train_b, val_b, test_b])
        tr_idx, va_idx, te_idx = stratified_three_way(np.asarray(pooled.y), seed=cfg.train.seed)
        train_b, val_b, test_b = (take_batch(pooled, tr_idx), take_batch(pooled, va_idx),
                                  take_batch(pooled, te_idx))
        print(f"[stratify] multilabel-stratified split -> train {len(tr_idx)} "
              f"| val {len(va_idx)} | test {len(te_idx)}")
    out_dir = args.out or os.path.join(cfg.out_dir, f"unimodal_{args.modality}")
    os.makedirs(out_dir, exist_ok=True)
    res = train_unimodal(cfg, train_b, val_b, test_b, modality=args.modality, task=data_task, tasks=tasks,
                         out_dir=out_dir, device=args.device)
    _print_unimodal(args.modality, res, out_dir)
    return 0


def synthetic_ct_split(n: int, seed: int) -> dict:
    """A seeded synthetic CT cohort [n, 6, 32, 32, 1] whose pe label is the
    sign of a fixed slab's mean intensity (the other three labels noise)."""
    r = np.random.default_rng(seed)
    x = r.normal(0.0, 1.0, size=(n, 6, 32, 32, 1)).astype(np.float32)
    slab = x[:, 2:4, 8:24, 8:24, 0].mean(axis=(1, 2, 3))
    y = np.stack([(slab > 0).astype(np.float32)] + [r.integers(0, 2, n).astype(np.float32) for _ in range(3)],
                 axis=1)
    # the signal made visible above the noise floor at small n
    x[:, 2:4, 8:24, 8:24, 0] += np.where(slab > 0, 1.5, -1.5)[:, None, None, None]
    return {"x": x, "y": y, "sens": r.integers(0, 2, n)}


def synthetic_omop_split(n: int, seed: int) -> dict:
    """A seeded synthetic OMOP cohort: concept ids from vocabularies 64 / 48 /
    56, the pe label the procedure id's parity (the other three noise)."""
    r = np.random.default_rng(seed)
    proc = r.integers(0, 64, n)
    y = np.stack([(proc % 2 == 0).astype(np.float32)] + [r.integers(0, 2, n).astype(np.float32)
                                                          for _ in range(3)], axis=1)
    return {"proc": proc, "meas": r.integers(0, 48, n), "drug": r.integers(0, 56, n), "y": y,
            "sens": r.integers(0, 2, n)}


def synthetic_splits(cfg, split) -> dict:
    """train / val / test of max(n, 64) / max(n // 4, 32) / max(n // 4, 32)
    records from `split(n, seed)` (n = data.synthetic_n), seeds train.seed
    + 0 / 1 / 2."""
    n, seed = cfg.data.synthetic_n, cfg.train.seed
    return {"train": split(max(n, 64), seed), "val": split(max(n // 4, 32), seed + 1),
            "test": split(max(n // 4, 32), seed + 2)}


def _cmd_unimodal_inspect(args) -> int:
    """INSPECT's OMOP concept multitask trainer (INSPECT/BEHRT.py) or its
    CT-volume one on the synthetic cohort (``synthetic_omop_split`` /
    ``synthetic_ct_split``); the OMOP one reads ``--inspect-csv``
    (final_structured_dataset.csv[.gz]: three concept-name columns and the
    INSPECT label columns, optional ``split`` / ``sens``) where given."""
    from multimodalrouting_tpu_torch.train.unimodal import INSPECT_TASKS, train_ct, train_omop

    cfg = _unimodal_cfg(args)
    out_dir = args.out or os.path.join(cfg.out_dir, f"unimodal_{args.modality}")
    os.makedirs(out_dir, exist_ok=True)
    t = cfg.train
    common = dict(hidden=cfg.model.d, lr=t.lr, weight_decay=t.weight_decay,
                  batch_size=t.batch_size, epochs=t.epochs, patience=t.early_stop_patience, seed=t.seed,
                  out_dir=out_dir, device=args.device)
    if args.modality == "omop" and args.inspect_csv:
        from multimodalrouting_tpu_torch.data.inspect_etl import load_inspect_structured

        data = load_inspect_structured(args.inspect_csv, seed=t.seed)
        vocab_sizes = tuple(int(v) for v in data.pop("_vocab_sizes"))
        tasks = INSPECT_TASKS[:len(data.pop("_tasks"))]
        res = train_omop(data, vocab_sizes=vocab_sizes, tasks=tasks, **common)
    elif args.modality == "omop":
        res = train_omop(synthetic_splits(cfg, synthetic_omop_split), vocab_sizes=(64, 48, 56), **common)
    else:
        res = train_ct(synthetic_splits(cfg, synthetic_ct_split), backbone=cfg.encoder.vision_backbone, **common)
    _print_unimodal(args.modality, res, out_dir)
    return 0


def cmd_etl(args) -> int:
    """The offline ETL drivers, the JAX CLI's subcommands on the port's
    ``data/`` modules:

      etl varmap  — cohort/build_varmap_17.py
      etl cohort  — cohort/build_cohort.py main:590
      etl export  — cohort/export_model_inputs.py main:164
      etl medfuse — MedFuse_Preprocessing/fusion_main.py:27-71 (listfile +
                    per-stay CSV chain) to parquet model inputs
      etl inspect — INSPECT/Data/00+01+02 (cohort merge, long OMOP EHR
                    filtered to study_time, impressions with labels)
      etl legacy  — Data/icustay_dataset.py:83-197 (wide lab pivot + PE/PH
                    labels + cleaned concatenated notes)

    ``varmap`` -> ``cohort`` -> ``export`` take a raw MIMIC-style csv.gz dump
    to the parquet model inputs that ``train --set data.synthetic=false
    --set data.data_root=EXPORT`` reads."""
    import pandas as pd

    if args.etl_cmd == "varmap":
        from multimodalrouting_tpu_torch.data.varmap import build_varmap

        def read_dict(name):
            for cand in (name + ".csv.gz", name + ".csv"):
                p = os.path.join(args.data_dir, cand)
                if os.path.exists(p):
                    return pd.read_csv(p)
            raise SystemExit(f"missing {name}.csv[.gz] under {args.data_dir}")

        vm = build_varmap(read_dict("d_items"), read_dict("d_labitems"))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
        vm.to_csv(args.out, index=False)
        print(json.dumps({"varmap": args.out, "rows": int(len(vm)), "variables": int(vm["variable"].nunique())}))
        return 0

    if args.etl_cmd == "cohort":
        from multimodalrouting_tpu_torch.data.cohort import CohortConfig, build_cohort

        master = build_cohort(CohortConfig(
            data_dir=args.data_dir, out_dir=args.out, varmap_path=args.varmap, cxr_meta_path=args.cxr_meta,
            notes_path=args.notes, listfile_dir=args.listfile_dir, seed=args.seed, min_age=args.min_age,
            window_hours=args.window_hours, bin_hours=args.bin_hours, ccs_map9_path=args.ccs_map9,
            ccs_map10_path=args.ccs_map10,
        ))
        print(json.dumps({"cohort": args.out, "stays": int(len(master)),
                          "splits": {k: int(v) for k, v in master["split"].value_counts().items()}}))
        return 0

    if args.etl_cmd == "export":
        from multimodalrouting_tpu_torch.data.exporter import export_model_inputs
        from multimodalrouting_tpu_torch.data.tokenization import ChunkingConfig

        export_model_inputs(args.cohort, args.out, tokenizer_name=args.tokenizer,
                            chunking=ChunkingConfig(max_len=args.max_len, stride=args.stride,
                                                    max_chunks=args.max_chunks))
        print(json.dumps({"export": args.out, "files": sorted(os.listdir(args.out))}))
        return 0

    if args.etl_cmd == "medfuse":
        from multimodalrouting_tpu_torch.data.medfuse import medfuse_export

        summary = medfuse_export(
            args.ehr_data_dir, args.task, args.out, timestep=args.timestep, impute_strategy=args.impute,
            config_path=args.channels_config, normalizer_state=args.normalizer_state,
            period_length=args.period_length, cxr_data_dir=args.cxr_data_dir, icu_stays_csv=args.icu_stays,
            data_pairs=args.data_pairs, data_ratio=args.data_ratio, seed=args.seed,
        )
        print(json.dumps(summary))
        return 0

    if args.etl_cmd == "inspect":
        from multimodalrouting_tpu_torch.data.inspect_etl import (
            OMOP_TABLES,
            build_long_ehr,
            impressions_with_labels,
            merge_cohort,
        )

        def read(path, required=True):
            if path is None or not os.path.exists(path):
                if required:
                    raise SystemExit(f"missing required input {path!r}")
                return None
            # sep=None sniffs tsv vs csv (the reference's inputs are tsv)
            return pd.read_csv(path, sep=None, engine="python")

        metadata, mapping, labels, splits = (read(p) for p in (args.metadata, args.mapping, args.labels,
                                                               args.splits))
        imps = read(args.impressions, required=False)
        cohort = merge_cohort(metadata, mapping, labels, splits, imps)
        os.makedirs(args.out, exist_ok=True)
        cohort_csv = os.path.join(args.out, "inspect_cohort.csv")
        cohort.to_csv(cohort_csv, index=False)
        outputs = {"cohort": cohort_csv, "rows": int(len(cohort))}
        if args.omop_dir:
            tables = {}
            for name in OMOP_TABLES:
                for cand in (f"{name}.csv.gz", f"{name}.csv"):
                    p = os.path.join(args.omop_dir, cand)
                    if os.path.exists(p):
                        tables[name] = pd.read_csv(p, low_memory=False)
                        break
            long = build_long_ehr(tables, cohort, demographics=read(args.demographics, required=False))
            ehr_csv = os.path.join(args.out, "inspect_long_ehr.csv.gz")
            long.to_csv(ehr_csv, index=False, compression="gzip")
            outputs["long_ehr"] = ehr_csv
            outputs["ehr_rows"] = int(len(long))
        if imps is not None:
            iw_csv = os.path.join(args.out, "inspect_impressions_with_labels.csv")
            impressions_with_labels(imps, labels).to_csv(iw_csv, index=False)
            outputs["impressions_with_labels"] = iw_csv
        print(json.dumps(outputs))
        return 0

    if args.etl_cmd == "legacy":
        from multimodalrouting_tpu_torch.data.legacy_cohort import load_legacy_cohort

        structured, notes = load_legacy_cohort(args.data_dir, window_hours=args.window_hours,
                                               bin_hours=args.bin_hours)
        os.makedirs(args.out, exist_ok=True)
        s_csv = os.path.join(args.out, "final_structured_dataset.csv")
        n_csv = os.path.join(args.out, "final_unstructured_notes.csv")
        structured.to_csv(s_csv, index=False)
        # the reference embeds the notes offline (Data/icustay_dataset.py:150-197);
        # here `unimodal --modality note` embeds them, so the export carries
        # the cleaned concatenated text
        notes.to_csv(n_csv, index=False)
        print(json.dumps({"structured": s_csv, "rows": int(len(structured)),
                          "notes": n_csv, "note_rows": int(len(notes))}))
        return 0

    raise SystemExit(f"unknown etl subcommand {args.etl_cmd!r}")


def cmd_interpret(args) -> int:
    """Interpretability sweep and inference demo on a gated-concat
    checkpoint (its EMA weights) over the first ``--max-samples`` stays of
    the test split, route availability from modality presence."""
    import csv

    import torch

    from multimodalrouting_tpu_torch.audit.sweep import gated_model_sweep, print_inference_demo, sweep_to_rows
    from multimodalrouting_tpu_torch.ckpt import load_config, load_serving
    from multimodalrouting_tpu_torch.data.batches import batch_to, slice_batch
    from multimodalrouting_tpu_torch.models.full import build_model
    from multimodalrouting_tpu_torch.routes import ROUTES_7, route_mask_from_presence

    cfg = load_config(args.ckpt, args.name)
    _check_cfg(cfg, "gated_concat")
    model = build_model(cfg, "gated_concat", device=args.device)
    weights, _ = load_serving(args.ckpt, args.name, like=model.state_dict())
    model.load_state_dict(weights)
    test_b, _ = _load_split(cfg, cfg.model.task, "test")
    batch = batch_to(slice_batch(test_b, 0, min(test_b.batch_size, args.max_samples)), args.device)
    with torch.inference_mode():
        out = model(batch)
    avail = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, ROUTES_7)
    sweep = gated_model_sweep(cfg, model, out.pooled, avail=avail, n_mc=args.n_mc)
    print_inference_demo(sweep, k=args.demo_samples)
    if args.out_csv:
        rows = sweep_to_rows(sweep)
        with open(args.out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"[interpret] wrote {len(rows)} rows -> {args.out_csv}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser (cli.py:858-1023), plus --device."""
    ap = argparse.ArgumentParser(prog="multimodalrouting_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="run on the CUDA card (default) or the CPU")

    tr = sub.add_parser("train", help="train a model family")
    tr.add_argument("--family", default="capsule", choices=FAMILIES)
    tr.add_argument("--task", choices=["mort", "pheno", "multitask"], default=None)
    tr.add_argument("--routes", choices=["7", "10"], default=None)
    tr.add_argument("--stage", default=None,
                    help="step1|step2|step3 (gated_concat) or uni|bi|tri (fame)")
    tr.add_argument("--config", default=None, help="YAML/JSON config file")
    tr.add_argument("--set", action="append", metavar="KEY=VALUE")
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--out", default=None)
    tr.add_argument("--init-from", default=None,
                    help="checkpoint dir to warm-start from (stage chaining)")
    tr.add_argument("--init-name", default="final")
    tr.add_argument("--resume", default=None,
                    help="checkpoint dir for full resume (optimizer + step)")
    tr.add_argument("--mesh", default=None, metavar="data=N[,model=M]",
                    help="multi-chip mesh spec, e.g. data=8 or data=4,model=2 "
                         "(shorthand for train.num_data_shards/num_model_shards)")
    tr.add_argument("--profile-dir", default=None,
                    help="torch.profiler Chrome trace output dir")
    device(tr)
    tr.set_defaults(fn=cmd_train)

    un = sub.add_parser("unimodal", help="unimodal trainers + fairness report")
    un.add_argument("--modality", default="behrt", choices=["behrt", "note", "omop", "ct"])
    un.add_argument("--task", default=None, choices=["mort", "readmit", "multitask", "pheno"])
    un.add_argument("--inspect-csv", default=None)
    un.add_argument("--impressions-csv", default=None)
    un.add_argument("--stride", type=int, default=64)
    un.add_argument("--vocab", default=None)
    un.add_argument("--stratify", default="auto", choices=["auto", "on", "off"])
    un.add_argument("--config", default=None)
    un.add_argument("--set", action="append", metavar="KEY=VALUE")
    un.add_argument("--epochs", type=int, default=None)
    un.add_argument("--out", default=None)
    device(un)
    un.set_defaults(fn=cmd_unimodal)

    ev = sub.add_parser("eval", help="evaluate a checkpoint + audit exports")
    ev.add_argument("--ckpt", required=True)
    ev.add_argument("--name", default="final")
    ev.add_argument("--family", default="capsule")
    ev.add_argument("--drop-table", action="store_true")
    ev.add_argument("--out", default=None)
    device(ev)
    ev.set_defaults(fn=cmd_eval)

    et = sub.add_parser("etl", help="offline ETL: raw csv.gz -> cohort -> model inputs")
    esub = et.add_subparsers(dest="etl_cmd", required=True)
    ev0 = esub.add_parser("varmap")
    ev0.add_argument("--data-dir", required=True)
    ev0.add_argument("--out", required=True)
    ec = esub.add_parser("cohort")
    ec.add_argument("--data-dir", required=True)
    ec.add_argument("--out", required=True)
    ec.add_argument("--varmap", required=True)
    ec.add_argument("--cxr-meta", default=None)
    ec.add_argument("--notes", default=None)
    ec.add_argument("--listfile-dir", default=None)
    ec.add_argument("--seed", type=int, default=2022)
    ec.add_argument("--min-age", type=float, default=18.0)
    ec.add_argument("--window-hours", type=int, default=48)
    ec.add_argument("--bin-hours", type=int, default=2)
    ec.add_argument("--ccs-map9", default=None)
    ec.add_argument("--ccs-map10", default=None)
    ex = esub.add_parser("export")
    ex.add_argument("--cohort", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--max-len", type=int, default=512)
    ex.add_argument("--stride", type=int, default=64)
    ex.add_argument("--max-chunks", type=int, default=8)
    ex.add_argument("--tokenizer", default="emilyalsentzer/Bio_ClinicalBERT")
    em = esub.add_parser("medfuse")
    em.add_argument("--ehr-data-dir", required=True)
    em.add_argument("--task", default="phenotyping", choices=["in-hospital-mortality", "phenotyping"])
    em.add_argument("--out", required=True)
    em.add_argument("--timestep", type=float, default=1.0)
    em.add_argument("--impute", default="previous", choices=["zero", "normal_value", "previous", "next"])
    em.add_argument("--channels-config", default=None)
    em.add_argument("--normalizer-state", default=None)
    em.add_argument("--period-length", type=float, default=48.0)
    em.add_argument("--cxr-data-dir", default=None)
    em.add_argument("--icu-stays", default=None)
    em.add_argument("--data-pairs", default="partial_ehr_cxr",
                    choices=["paired_ehr_cxr", "paired_ehr", "partial_ehr", "partial_ehr_cxr"])
    em.add_argument("--data-ratio", type=float, default=1.0)
    em.add_argument("--seed", type=int, default=0)
    ei = esub.add_parser("inspect")
    ei.add_argument("--metadata", required=True)
    ei.add_argument("--mapping", required=True)
    ei.add_argument("--labels", required=True)
    ei.add_argument("--splits", required=True)
    ei.add_argument("--impressions", default=None)
    ei.add_argument("--omop-dir", default=None)
    ei.add_argument("--demographics", default=None)
    ei.add_argument("--out", required=True)
    el = esub.add_parser("legacy")
    el.add_argument("--data-dir", required=True)
    el.add_argument("--out", required=True)
    el.add_argument("--window-hours", type=int, default=24)
    el.add_argument("--bin-hours", type=int, default=2)
    et.set_defaults(fn=cmd_etl)

    pr = sub.add_parser("predict", help="serving: calibrated predictions as JSONL or HTTP")
    pr.add_argument("--ckpt", default=None, help="checkpoint dir (live Predictor)")
    pr.add_argument("--artifact", default=None, help="serve an exported artifact dir instead of a checkpoint")
    pr.add_argument("--export-artifact", default=None, metavar="DIR",
                    help="export --ckpt as a self-contained serving artifact and exit")
    pr.add_argument("--platforms", default=None, help="comma list for --export-artifact")
    pr.add_argument("--name", default="final")
    pr.add_argument("--family", default="capsule")
    pr.add_argument("--split", default="test")
    pr.add_argument("--batch-size", type=int, default=None,
                    help="serving batch (default: training batch size)")
    pr.add_argument("--out", default=None, help="JSONL output path")
    pr.add_argument("--port", type=int, default=None,
                    help="start a JSON HTTP server instead of scoring a split")
    device(pr)
    pr.set_defaults(fn=cmd_predict)

    it = sub.add_parser("interpret", help="occlusion + UC/BI/TI sweep + inference demo")
    it.add_argument("--ckpt", required=True)
    it.add_argument("--name", default="final")
    it.add_argument("--n-mc", type=int, default=20)
    it.add_argument("--max-samples", type=int, default=256)
    it.add_argument("--demo-samples", type=int, default=5)
    it.add_argument("--out-csv", default=None)
    device(it)
    it.set_defaults(fn=cmd_interpret)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
