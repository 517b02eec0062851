"""Inference surface: checkpoint -> predictor -> JSONL / HTTP (counterpart of
multimodalrouting_tpu/serve.py, with the same record format and JSON
contract).

- Request records are dicts of (possibly missing) modality arrays;
  ``batch_from_records`` pads or crops them to the checkpoint's static
  shapes and derives the ``has_*`` presence flags from what each record
  carries (missing modalities are zeroed and masked, never imputed).
- ``Predictor`` loads a checkpoint of any family, the port's or the JAX
  package's (``ckpt.py``; JAX's ``name=``), onto the card (or the CPU when
  asked) and applies the checkpoint's temperature
  and per-label thresholds to every prediction. Rows carry what the family
  exposes: the capsule family's route audit (alpha [R], R-matrix [R, K],
  top routes); the other families' rows carry probabilities and decisions
  only (their routes are the 7). Under the loss-based sMRO gate the forward
  takes the route-loss EMA the checkpoint carries (zeros where it carries
  none). Requests are scored in slices of at most ``batch_size``
  rows; eager PyTorch needs no padding to a static batch. ``warmup`` runs
  one forward before the first request (``cli predict --port`` calls it).
- ``make_http_server``: POST /predict, GET /health.
- Spans (``utils/profiling.py``, kept only while a profile records) mark
  a request's phases: ``serve.request`` around it, ``serve.assemble``,
  ``serve.queue`` (the wait for the device lock), ``serve.to_device``,
  ``serve.forward``, ``serve.readback`` and ``serve.rows``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch, batch_to, slice_batch
from multimodalrouting_tpu_torch.utils.profiling import annotate, count, recording


def _serving_shapes(cfg: Config) -> Dict[str, int]:
    """Static per-sample shapes: a synthetic-cohort checkpoint serves the
    clipped shapes it was trained on (notes 128 tokens, images 96^2); a
    real-cohort one (data_root set, synthetic off) the configured ones."""
    synth = cfg.data.synthetic or not cfg.data.data_root
    return {
        "t": cfg.encoder.structured_seq_len,
        "f": cfg.encoder.structured_n_feats,
        "s": cfg.encoder.notes_max_chunks,
        "l": min(cfg.encoder.text_max_len, 128) if synth else cfg.encoder.text_max_len,
        "hw": min(cfg.encoder.image_size, 96) if synth else cfg.encoder.image_size,
        "k": 25 if cfg.model.task == "pheno" else 1,
    }


def _fit_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Pad with trailing zeros or crop an axis to `size`."""
    cur = a.shape[axis]
    if cur == size:
        return a
    if cur > size:
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, size)
        return a[tuple(sl)]
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - cur)
    return np.pad(a, pad)


def batch_from_records(cfg: Config, records: Sequence[Dict]) -> Batch:
    """Assemble request records into one static-shape host Batch.

    A record may carry any of: ``x_struct`` [T, F] (+ ``m_struct`` [T]),
    ``note_ids`` [S, L] (+ ``note_attn`` [S, L], ``chunk_mask`` [S]),
    ``image`` [H, W, 3], ``y``, ``sens``.
    """
    sh = _serving_shapes(cfg)
    n = len(records)
    t, f, s, l, hw, k = sh["t"], sh["f"], sh["s"], sh["l"], sh["hw"], sh["k"]

    x_struct = np.zeros((n, t, f), np.float32)
    m_struct = np.zeros((n, t), np.float32)
    note_ids = np.zeros((n, s, l), np.int32)
    note_attn = np.zeros((n, s, l), np.int32)
    chunk_mask = np.zeros((n, s), np.float32)
    image = np.zeros((n, hw, hw, 3), np.float32)
    has_l = np.zeros((n,), np.float32)
    has_n = np.zeros((n,), np.float32)
    has_i = np.zeros((n,), np.float32)
    y = np.zeros((n,) if k == 1 else (n, k), np.float32)
    sens = np.zeros((n,), np.int32)

    for i, rec in enumerate(records):
        if rec.get("x_struct") is not None:
            xs = np.asarray(rec["x_struct"], np.float32)
            if xs.ndim != 2:
                raise ValueError(f"record {i}: x_struct must be [T,F], got {xs.shape}")
            x_struct[i] = _fit_axis(_fit_axis(xs, 0, t), 1, f)
            if rec.get("m_struct") is not None:
                m_struct[i] = _fit_axis(np.asarray(rec["m_struct"], np.float32), 0, t)
            else:
                m_struct[i, : min(xs.shape[0], t)] = 1.0
            has_l[i] = 1.0
        if rec.get("note_ids") is not None:
            ids = np.asarray(rec["note_ids"], np.int64)
            if ids.ndim != 2:
                raise ValueError(f"record {i}: note_ids must be [S,L], got {ids.shape}")
            ids = _fit_axis(_fit_axis(ids, 0, s), 1, l)
            note_ids[i] = ids.astype(np.int32)
            if rec.get("note_attn") is not None:
                note_attn[i] = _fit_axis(
                    _fit_axis(np.asarray(rec["note_attn"], np.int64), 0, s), 1, l
                ).astype(np.int32)
            else:
                note_attn[i] = (ids != 0).astype(np.int32)
            if rec.get("chunk_mask") is not None:
                chunk_mask[i] = _fit_axis(np.asarray(rec["chunk_mask"], np.float32), 0, s)
            else:
                chunk_mask[i] = (note_attn[i].sum(axis=-1) > 0).astype(np.float32)
            has_n[i] = float(chunk_mask[i].any())
        if rec.get("image") is not None:
            img = np.asarray(rec["image"], np.float32)
            if img.ndim != 3 or img.shape[-1] != 3:
                raise ValueError(f"record {i}: image must be [H,W,3], got {img.shape}")
            image[i] = _fit_axis(_fit_axis(img, 0, hw), 1, hw)
            has_i[i] = 1.0
        if rec.get("y") is not None:
            y[i] = np.asarray(rec["y"], np.float32)
        if rec.get("sens") is not None:
            sens[i] = int(rec["sens"])

    if recording():
        count("serve.chunks", int((chunk_mask > 0).sum()))
    return Batch(
        x_struct=x_struct, m_struct=m_struct, note_ids=note_ids, note_attn=note_attn,
        chunk_mask=chunk_mask, image=image, has_l=has_l, has_n=has_n, has_i=has_i,
        y=y, sens=sens,
    )


def probs_from_logits(logits: np.ndarray, task: str) -> np.ndarray:
    """Logits -> probabilities; mort with 2 classes uses the death-logit
    contrast logits[:,1] - logits[:,0]."""
    if task == "mort" and logits.ndim == 2 and logits.shape[-1] == 2:
        return 1.0 / (1.0 + np.exp(-(logits[:, 1] - logits[:, 0])))
    return 1.0 / (1.0 + np.exp(-logits))


def calibrate_probs(probs: np.ndarray, temperature: float) -> np.ndarray:
    """Apply the fitted temperature in logit space (identity at T=1)."""
    if temperature == 1.0:
        return probs
    eps = 1e-7
    p = np.clip(probs, eps, 1 - eps)
    logits = np.log(p) - np.log1p(-p)
    return 1.0 / (1.0 + np.exp(-logits / temperature))


def decide(probs: np.ndarray, thresholds: Optional[np.ndarray]) -> np.ndarray:
    """Hard decisions from calibrated probs + per-label thresholds."""
    if thresholds is not None:
        th = thresholds if probs.ndim == 2 else float(thresholds[0])
        return (probs >= th).astype(np.int32)
    return (probs >= 0.5).astype(np.int32)


def rows_from_output(out: Dict[str, np.ndarray], n: int, routes: Sequence[str], temperature: float) -> List[Dict]:
    """Per-sample JSON-safe rows."""
    results = []
    for i in range(n):
        row: Dict = {
            "probs": np.round(out["probs"][i], 6).tolist(),
            "pred": out["pred"][i].tolist(),
            "temperature": temperature,
        }
        if "alpha" in out and out["alpha"] is not None:
            a = np.asarray(out["alpha"][i], np.float64).reshape(-1)
            row["alpha"] = {r: round(float(v), 6) for r, v in zip(routes, a)}
            order = np.argsort(-a)[:3]
            row["top_routes"] = [routes[j] for j in order]
        results.append(row)
    return results


class Predictor:
    """Load a port checkpoint once; serve calibrated predictions + route audit."""

    def __init__(self, ckpt_dir: str, family: str = "capsule", *, name: Optional[str] = None,
                 batch_size: Optional[int] = None, device="cuda"):
        """Checkpoint `name` in `ckpt_dir`, in the port's format or the JAX
        package's (``ckpt.resolve``). Without a name, `ckpt_dir` is the
        checkpoint's own path (``<dir>/<name>``) where it is a port checkpoint
        directory or no directory at all, else JAX's default name, ``final``."""
        from multimodalrouting_tpu_torch.ckpt import load_config, load_meta, load_serving
        from multimodalrouting_tpu_torch.models.full import build_model
        from multimodalrouting_tpu_torch.routes import get_routes
        from multimodalrouting_tpu_torch.train.state import n_route_loss_ema_for
        from multimodalrouting_tpu_torch.train.steps import loss_family

        if name is None and os.path.isdir(ckpt_dir) and not os.path.isfile(os.path.join(ckpt_dir, "config.json")):
            name = "final"
        cfg = load_config(ckpt_dir, name)
        self.cfg = cfg
        self.family = family
        self.batch_size = int(batch_size or cfg.train.batch_size)
        self.task = cfg.model.task
        self.ckpt_dir = ckpt_dir
        self.model = build_model(cfg, family, device=device)
        self.device = next(self.model.parameters()).device
        weights, rle = load_serving(ckpt_dir, name, like=self.model.state_dict())
        self.model.load_state_dict(weights)
        meta = load_meta(ckpt_dir, name)
        self.temperature = float(meta.get("temperature", 1.0) or 1.0)
        th = meta.get("thresholds")
        self.thresholds = np.asarray(th, np.float64) if th else None
        self.routes: List[str] = list(get_routes(cfg.model.routes if family == "capsule" else "7"))
        n_ema = n_route_loss_ema_for(cfg, loss_family(family))
        self.route_loss_ema = None
        if n_ema:
            self.route_loss_ema = torch.tensor(rle or [0.0] * n_ema, device=self.device)
        self._lock = threading.Lock()  # one request at a time on the device

    def warmup(self) -> None:
        """Pay what a first request would before the first request: one
        serving forward of an empty record, as the JAX package warms up.
        Eager PyTorch compiles nothing per shape; on the card that forward
        builds and loads the kernels it launches (``ops/hopper.py``) and lets
        cuBLAS and cuDNN set up. An empty record still runs every encoder:
        BERT over its all-pad chunks takes its attention branch by shape, so
        it launches K1 in every layer and the head K3, as a real record does."""
        self.predict(batch_from_records(self.cfg, [{}]))

    def forward(self, batch: Batch):
        """The serving forward of a host Batch -> the model's ModelOutput."""
        kwargs = {} if self.route_loss_ema is None else {"route_losses_ema": self.route_loss_ema}
        with torch.inference_mode():
            with annotate("serve.to_device"):
                batch = batch_to(batch, self.device)
            with annotate("serve.forward"):
                return self.model(batch, **kwargs)

    def _forward(self, batch: Batch):
        out = self.forward(batch)
        with annotate("serve.readback"):
            return tuple(None if x is None else x.cpu().numpy() for x in (out.logits, out.alpha, out.r_matrix))

    def predict(self, batch: Batch) -> Dict[str, np.ndarray]:
        """probs [N] or [N,K], pred, and where the family exposes routing
        alpha [N,R] and r_matrix [N,R,K]."""
        n = batch.batch_size
        parts = []
        with annotate("serve.queue"):  # the wait for the device: another request's forward
            self._lock.acquire()
        try:
            for start in range(0, n, self.batch_size):
                sub = slice_batch(batch, start, self.batch_size)
                parts.append(self._forward(sub))
        finally:
            self._lock.release()
        with annotate("serve.rows"):
            logits, alpha, r_matrix = (None if xs[0] is None else np.concatenate(xs, 0) for xs in zip(*parts))
            probs = calibrate_probs(probs_from_logits(logits, self.task), self.temperature)
            out: Dict[str, np.ndarray] = {"probs": probs, "pred": decide(probs, self.thresholds)}
        if alpha is not None:
            out["alpha"] = alpha
        if r_matrix is not None:
            out["r_matrix"] = r_matrix
        return out

    def predict_records(self, records: Sequence[Dict]) -> List[Dict]:
        with annotate("serve.request"):
            with annotate("serve.assemble"):
                batch = batch_from_records(self.cfg, records)
            out = self.predict(batch)
            return self._rows_from_output(out, len(records))

    def _rows_from_output(self, out: Dict[str, np.ndarray], n: int) -> List[Dict]:
        with annotate("serve.rows"):
            return rows_from_output(out, n, self.routes, self.temperature)


def write_predictions_jsonl(predictor: Predictor, batch: Batch, out_path: str, stay_ids: Optional[np.ndarray] = None) -> int:
    """Score a whole cohort Batch; one JSON line per stay. Returns row count."""
    out = predictor.predict(batch)
    n = len(out["probs"])
    with open(out_path, "w") as fh:
        for i in range(n):
            row: Dict = {"probs": np.round(out["probs"][i], 6).tolist(), "pred": out["pred"][i].tolist()}
            if stay_ids is not None:
                row["stay_id"] = int(stay_ids[i])
            if "alpha" in out:
                a = np.asarray(out["alpha"][i], np.float64).reshape(-1)
                row["top_routes"] = [predictor.routes[j] for j in np.argsort(-a)[:3]]
            fh.write(json.dumps(row) + "\n")
    return n


def make_http_server(predictor: Predictor, port: int = 0, host: str = "127.0.0.1"):
    """JSON over HTTP around a Predictor (unstarted ThreadingHTTPServer).

    POST /predict  body {"records": [...]} -> {"predictions": [...]}
    GET  /health   -> {"ok": true, "family", "task", "routes", "batch_size", "temperature"}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    pred = predictor

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/health":
                self._send(200, {
                    "ok": True, "family": pred.family, "task": pred.task,
                    "routes": pred.routes, "batch_size": pred.batch_size,
                    "temperature": pred.temperature,
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            with annotate("serve.request"):
                self._predict()

        def _predict(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                records = req.get("records")
                if not isinstance(records, list) or not records:
                    raise ValueError("body must be {'records': [<record>, ...]}")
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            try:
                with annotate("serve.assemble"):
                    batch = batch_from_records(pred.cfg, records)
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, {"error": str(e)})
                return
            try:
                out = pred.predict(batch)
                self._send(200, {"predictions": pred._rows_from_output(out, len(records))})
            except Exception as e:  # device/internal failure: 500, not the client's fault
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)
