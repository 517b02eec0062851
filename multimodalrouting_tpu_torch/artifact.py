"""Versioned serving artifacts: checkpoint -> a ``torch.export`` program
(counterpart of multimodalrouting_tpu/artifact.py, which writes a
``jax.export`` StableHLO program).

An artifact directory holds:

- ``program.pt2``: the eval forward of a live ``serve.Predictor`` (EMA
  weights, presence-derived route masks, the frozen route-loss EMA under the
  loss-based sMRO gate) traced by ``torch.export.export`` under
  ``torch.no_grad()`` at the static batch ``predictor.batch_size`` and
  written by ``torch.export.save``, weights included. It returns
  ``(logits, alpha, r_matrix)`` as JAX's ``serving_fn`` does (alpha and
  r_matrix ``None`` for a family without them). Loading it needs no model
  code.
- ``meta.json``: JAX's schema (``format_version``, ``family``, ``task``,
  ``routes``, ``temperature``, ``thresholds``, ``batch_size``,
  ``platforms``, ``config``) plus ``program`` (the program's file name) and
  ``attention`` (the attention branch of the note encoder's layers at
  trace time: packed | flash | splash | eager; the ``MMR_ATTN`` selector is
  read while tracing, so the artifact fixes it).

The hand-written kernels are in the program as the custom ops
``mmr::packed_attention`` (K1), ``mmr::segment_attention`` (K4a / K4b's
forward) and ``mmr::capsule_routing`` (K3), registered by ``ops/``: on a
CUDA tensor each launches its kernel and adds to the wrapper's launch count,
on a CPU tensor it runs the plain version. So a program exported in a CPU
process serves on the card through the kernels once it is moved there
(``platforms=("cpu", "cuda")``: ``torch.export.passes.move_to_device_pass``
moves the weights, the constants and the devices the forward names).

Not AOTInductor: a compiled ``.so`` program cannot call the Python
implementations of the ctypes-launched kernels, so it would have to carry
their plain versions in their place.

``ExportedPredictor`` duck-types ``serve.Predictor`` (``predict``,
``predict_records``, ``warmup``, ``temperature``, ``routes``,
``batch_size``), so ``serve.write_predictions_jsonl``,
``serve.make_http_server`` and ``cli predict --artifact`` serve an artifact
unchanged. It imports no model code: only ``ops`` (to register the custom
ops), ``configs``, ``serve``'s record assembly and ``data.batches``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# registers the custom ops a program calls
from multimodalrouting_tpu_torch.ops import flash, flash_packed, fused_capsule  # noqa: F401

_PROGRAM = "program.pt2"
_META = "meta.json"
_JAX_PROGRAM = "program.jaxexp"

# Batch fields the serving program takes (y feeds the gated family's
# loss-based gate, as the live Predictor's forward reads it)
_FIELDS = (
    "x_struct", "m_struct", "note_ids", "note_attn", "chunk_mask",
    "image", "has_l", "has_n", "has_i", "y",
)


class _ServingProgram(torch.nn.Module):
    """The live Predictor's eval forward over the batch fields as arguments."""

    def __init__(self, model, route_loss_ema: Optional[torch.Tensor]):
        super().__init__()
        self.model = model
        self.route_loss_ema = route_loss_ema

    def forward(self, x_struct, m_struct, note_ids, note_attn, chunk_mask, image, has_l, has_n, has_i, y):
        from multimodalrouting_tpu_torch.data.batches import Batch

        batch = Batch(x_struct=x_struct, m_struct=m_struct, note_ids=note_ids, note_attn=note_attn,
                      chunk_mask=chunk_mask, image=image, has_l=has_l, has_n=has_n, has_i=has_i, y=y)
        kwargs = {} if self.route_loss_ema is None else {"route_losses_ema": self.route_loss_ema}
        out = self.model(batch, **kwargs)
        return out.logits, out.alpha, out.r_matrix


def _example_arrays(cfg, batch_size: int) -> Dict[str, np.ndarray]:
    from multimodalrouting_tpu_torch.serve import batch_from_records

    example = batch_from_records(cfg, [{} for _ in range(batch_size)])
    return {f: np.asarray(getattr(example, f)) for f in _FIELDS}


def _attention_branch(cfg) -> str:
    """The branch the note encoder's self-attention takes under the current
    selector, without a gradient (the serving program's)."""
    from multimodalrouting_tpu_torch.models.attention import attention_branch
    from multimodalrouting_tpu_torch.serve import _serving_shapes

    e = cfg.encoder
    t = _serving_shapes(cfg)["l"]
    return attention_branch(t, t, e.bert_hidden // e.bert_heads, e.bert_hidden, e.bert_heads,
                            frozen_fast_path=not e.finetune_text, needs_grad=False)


def export_serving_artifact(predictor, out_dir: str, *, platforms: Optional[Sequence[str]] = None) -> str:
    """Export a loaded ``serve.Predictor`` as an artifact directory.

    The program is traced on the predictor's device. `platforms` lists the
    devices (``cpu``, ``cuda``) the artifact is meant for and is written to
    ``meta.json``; the default is the predictor's device alone. A program
    traced on the CPU serves on the card (``ExportedPredictor(device=
    "cuda")``), the kernels' ops launching there.
    """
    from multimodalrouting_tpu_torch.configs import to_dict

    dev = predictor.device
    named = [str(p) for p in (platforms or [dev.type])]
    bad = [p for p in named if p not in ("cpu", "cuda")]
    if bad:
        raise ValueError(f"platforms are cpu and cuda, got {bad}")
    if dev.type not in named:
        raise ValueError(f"the predictor runs on {dev.type}, which platforms={named} does not list")
    arrays = _example_arrays(predictor.cfg, predictor.batch_size)
    args = tuple(torch.from_numpy(arrays[f]).to(dev) for f in _FIELDS)
    program = _ServingProgram(predictor.model, predictor.route_loss_ema).eval()
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, _PROGRAM))
    meta = {
        "format_version": 1,
        "family": predictor.family,
        "task": predictor.task,
        "routes": list(predictor.routes),
        "temperature": predictor.temperature,
        "thresholds": None if predictor.thresholds is None else predictor.thresholds.tolist(),
        "batch_size": predictor.batch_size,
        "platforms": named,
        "config": to_dict(predictor.cfg),
        "program": _PROGRAM,
        "traced_on": dev.type,
        "attention": _attention_branch(predictor.cfg),
    }
    with open(os.path.join(out_dir, _META), "w") as fh:
        json.dump(meta, fh, indent=1)
    return out_dir


class ExportedPredictor:
    """Serve an ``export_serving_artifact`` directory with no model code.

    Duck-types ``serve.Predictor``: ``predict(batch)``, ``predict_records``,
    ``warmup`` and the attributes the HTTP and JSONL frontends read. A request
    is scored in slices of the static batch; the tail slice is padded by a
    clipped gather (its last row repeated) and the pad rows dropped, as the
    JAX artifact pads.
    """

    def __init__(self, artifact_dir: str, device="cuda"):
        from multimodalrouting_tpu_torch.configs import from_dict

        meta_path = os.path.join(artifact_dir, _META)
        program_path = os.path.join(artifact_dir, _PROGRAM)
        if not os.path.exists(program_path) and os.path.exists(os.path.join(artifact_dir, _JAX_PROGRAM)):
            raise ValueError(
                f"{artifact_dir} holds the JAX package's StableHLO program ({_JAX_PROGRAM}), which needs JAX to "
                "run; serve the JAX checkpoint it was exported from through `cli predict --ckpt DIR --name NAME`"
            )
        with open(meta_path) as fh:
            meta = json.load(fh)
        if meta.get("format_version") != 1:
            raise ValueError(f"unsupported artifact format_version {meta.get('format_version')!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        self.cfg = from_dict(meta["config"])
        self.family: str = meta["family"]
        self.task: str = meta["task"]
        self.routes: List[str] = list(meta["routes"])
        self.temperature = float(meta["temperature"])
        th = meta["thresholds"]
        self.thresholds = None if th is None else np.asarray(th, np.float64)
        self.batch_size = int(meta["batch_size"])
        self.platforms: List[str] = list(meta["platforms"])
        self.attention: str = meta["attention"]
        if self.device.type not in self.platforms:
            raise ValueError(f"the artifact was exported for {self.platforms}, not {self.device.type}")
        exported = torch.export.load(os.path.join(artifact_dir, meta["program"]))
        if meta["traced_on"] != self.device.type:
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, str(self.device))
        self._program = exported.module()
        self._dtypes = {f: a.dtype for f, a in _example_arrays(self.cfg, 1).items()}
        self._lock = threading.Lock()

    def warmup(self) -> None:
        from multimodalrouting_tpu_torch.serve import batch_from_records

        self.predict(batch_from_records(self.cfg, [{}]))

    def _call(self, arrays: Sequence[np.ndarray]):
        args = [torch.from_numpy(np.ascontiguousarray(a, dtype=self._dtypes[f])).to(self.device)
                for f, a in zip(_FIELDS, arrays)]
        with torch.inference_mode():
            out = self._program(*args)
        return tuple(None if x is None else x.cpu().numpy() for x in out)

    def predict(self, batch) -> Dict[str, np.ndarray]:
        """probs [N] or [N,K], pred, and where the family exposes routing
        alpha [N,R] and r_matrix [N,R,K]."""
        from multimodalrouting_tpu_torch.serve import calibrate_probs, decide, probs_from_logits

        n, bs = batch.batch_size, self.batch_size
        parts = []
        with self._lock:
            for start in range(0, n, bs):
                idx = np.minimum(np.arange(start, start + bs), n - 1)
                k = min(bs, n - start)
                out = self._call([np.asarray(getattr(batch, f))[idx] for f in _FIELDS])
                parts.append(tuple(None if x is None else x[:k] for x in out))
        logits, alpha, r_matrix = (None if xs[0] is None else np.concatenate(xs, 0) for xs in zip(*parts))
        probs = calibrate_probs(probs_from_logits(logits, self.task), self.temperature)
        out: Dict[str, np.ndarray] = {"probs": probs, "pred": decide(probs, self.thresholds)}
        if alpha is not None:
            out["alpha"] = alpha
        if r_matrix is not None:
            out["r_matrix"] = r_matrix
        return out

    def predict_records(self, records: Sequence[Dict]) -> List[Dict]:
        from multimodalrouting_tpu_torch.serve import batch_from_records

        out = self.predict(batch_from_records(self.cfg, records))
        return self._rows_from_output(out, len(records))

    def _rows_from_output(self, out: Dict[str, np.ndarray], n: int) -> List[Dict]:
        from multimodalrouting_tpu_torch.serve import rows_from_output

        return rows_from_output(out, n, self.routes, self.temperature)
