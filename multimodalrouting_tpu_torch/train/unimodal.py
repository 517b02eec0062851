"""The unimodal training trainers and their fairness report (counterpart of
multimodalrouting_tpu/train/unimodal.py):

- ``train_unimodal(modality="behrt")``: 01_BEHRT.py's 3-task wide BEHRT
  (mortality / PE / PH, pos_weight BCE summed over tasks) and 02_BEHRT.py's
  readmission model (focal loss, gamma 2.5);
- ``train_unimodal(modality="note")``: 01_BioClinicalBert.py, an MLP with the
  focal loss over note embeddings that the frozen chunked BERT
  (``_note_encoder``) computes once per split (``_embed_notes``; the two are
  the JAX trainer's ``_note_embeddings``);
- ``train_omop``: INSPECT/BEHRT.py's OMOP concept model, four tasks (or as
  many as an INSPECT CSV labels, ``cli unimodal --inspect-csv``);
- ``train_ct``: INSPECT's CT branch, a per-slice ResNet under GroupNorm.

Each is a small single-modality fit (``_fit``): epochs of a numpy
permutation from ``seed`` (the tail that does not fill a batch dropped), one
optimizer step per batch, the validation loss after each epoch, the best
parameters kept, the LR scale cut x0.1 after 2 epochs without a better
validation loss and an early stop after ``patience``; then one forward over
the test split gives each task's metrics and fairness report, written to
``out_dir`` as unimodal_metrics.json and fairness.json.

What the JAX trainers do and this module keeps:

- the optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(1.0,
  weight_decay))`` with the update multiplied by the LR scale (``_AdamW``):
  every parameter is decayed, biases, LayerNorms and embeddings too, and
  Adam's eps is added outside the square root;
- the validation loss is always the pos_weight BCE, also where the model
  trains on the focal loss;
- ``_note_encoder`` builds its own encoder without ``encoder.bert_ln``, so
  its LayerNorms run the fp32 chain, and loads ``encoder.bert_weights`` where
  set. The JAX package draws that encoder's random init from
  ``PRNGKey(seed)``, which torch cannot reproduce; here it comes from the
  torch generator seeded with ``seed``.

Models are built on the CPU under a forked global RNG seeded with ``seed``
and moved to ``device`` (the card unless the caller passes "cpu"); dropout
draws from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.metrics.classification import epoch_metrics
from multimodalrouting_tpu_torch.metrics.fairness import fairness_report
from multimodalrouting_tpu_torch.models.inspect import INSPECT_TASKS, CTVolumeEncoder, OMOPConceptModel
from multimodalrouting_tpu_torch.models.layers import Dense
from multimodalrouting_tpu_torch.models.unimodal import NoteEmbeddingClassifier, WideBEHRTClassifier
from multimodalrouting_tpu_torch.train.losses import bce_with_logits, focal_pos_weight_bce
from multimodalrouting_tpu_torch.train.state import ADAM_B1, ADAM_B2, ADAM_EPS


class UnimodalResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # the best state_dict
    metrics: Dict[str, Dict[str, float]]  # per task
    fairness: Dict[str, Any]  # per task fairness report
    history: List[Dict[str, float]]


def _pos_weight(y: np.ndarray) -> float:
    """neg/pos class weight (01_BEHRT.py:160-162 / 02_BEHRT class_weight)."""
    pos = float((y > 0.5).sum())
    neg = float((y <= 0.5).sum())
    return neg / pos if pos > 0 else 1.0


def _tasks_for(y: np.ndarray, task: str) -> Tuple[str, ...]:
    if y.ndim == 2 and y.shape[1] == 3:
        return ("mortality", "pe", "ph")
    return ("readmit",) if task == "readmit" else ("mortality",)


def _stack_y(y):
    return y if y.ndim == 2 else y[:, None]


def _seeded(seed: int, build: Callable[[], nn.Module], device) -> nn.Module:
    """build() on the CPU under the global RNG seeded with `seed` (the
    caller's RNG state restored after), moved to `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    return model.to(device)


class _AdamW:
    """optax ``chain(clip_by_global_norm(1.0), adamw(learning_rate=1.0,
    weight_decay))`` on every parameter, the update then scaled by
    ``lr_scale``: p -= lr_scale * (m_hat / (sqrt(v_hat) + eps) + wd * p)."""

    def __init__(self, params: Sequence[torch.Tensor], weight_decay: float, max_norm: float = 1.0):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.weight_decay, self.max_norm, self.count = weight_decay, max_norm, 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr_scale: float) -> None:
        g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        clip = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm), self.max_norm / g_norm)
        self.count += 1
        c1, c2 = 1.0 - ADAM_B1**self.count, 1.0 - ADAM_B2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g * clip
            mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
            nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * g * g)
            update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS) + self.weight_decay * p
            p.sub_(lr_scale * update)


def _logits(out, tasks, dict_output: bool) -> torch.Tensor:
    return torch.stack([out[t] for t in tasks], dim=1) if dict_output else _stack_y(out)


def _val_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor, pw: torch.Tensor, tasks, dict_output: bool) -> float:
    """The pos_weight BCE summed over tasks on the whole split, in eval mode
    (whatever loss the fit trains on)."""
    with torch.no_grad():
        per = bce_with_logits(_logits(model(x), tasks, dict_output), y, pos_weight=pw, reduce=False)
    return float(per.mean(dim=0).sum())


def _fit(
    model: nn.Module,
    feats_train: np.ndarray,
    y_train: np.ndarray,
    feats_val: np.ndarray,
    y_val: np.ndarray,
    *,
    tasks: Tuple[str, ...],
    loss_kind: str,  # "pos_weight_bce" | "focal"
    focal_gamma: float,
    lr: float,
    weight_decay: float,
    batch_size: int,
    epochs: int,
    patience: int,
    seed: int,
    log_fn: Callable[[str], None],
    dict_output: bool = True,
) -> Tuple[Dict[str, torch.Tensor], List[Dict[str, float]]]:
    """Fit `model` (on its device, from its current weights) -> (the best
    state_dict, which the model is left holding; the history)."""
    dev = next(model.parameters()).device
    y_train2, y_val2 = _stack_y(np.asarray(y_train)), _stack_y(np.asarray(y_val))
    pw = torch.tensor([_pos_weight(y_train2[:, i]) for i in range(len(tasks))], dtype=torch.float32, device=dev)
    x_tr, y_tr = torch.as_tensor(np.asarray(feats_train)).to(dev), torch.as_tensor(y_train2).float().to(dev)
    x_va, y_va = torch.as_tensor(np.asarray(feats_val)).to(dev), torch.as_tensor(y_val2).float().to(dev)
    params = [p for p in model.parameters()]
    opt = _AdamW(params, weight_decay)
    generator = torch.Generator(device=dev).manual_seed(seed)

    def loss_fn(x, y):
        logits = _logits(model(x, generator), tasks, dict_output)
        if loss_kind == "focal":
            per = focal_pos_weight_bce(logits, y, gamma=focal_gamma, pos_weight=pw, reduce=False)
        else:
            per = bce_with_logits(logits, y, pos_weight=pw, reduce=False)
        return per.mean(dim=0).sum()  # sum of per-task means (01_BEHRT.py:178)

    n = x_tr.shape[0]
    steps = max(n // batch_size, 1)
    np_rng = np.random.default_rng(seed)
    best, wait, plateau_wait = np.inf, 0, 0
    lr_scale = lr
    snapshot = lambda: {k: v.detach().clone() for k, v in model.state_dict().items()}  # noqa: E731
    best_params = snapshot()
    history: List[Dict[str, float]] = []
    for ep in range(epochs):
        order = np_rng.permutation(n)
        tl = []
        model.train()
        for s in range(steps):
            sel = torch.as_tensor(order[s * batch_size : (s + 1) * batch_size], device=dev)
            loss = loss_fn(x_tr[sel], y_tr[sel])
            grads = torch.autograd.grad(loss, params)
            opt.step(grads, lr_scale)
            tl.append(float(loss.detach()))
        model.eval()
        vl = _val_loss(model, x_va, y_va, pw, tasks, dict_output)
        history.append({"epoch": ep, "train_loss": float(np.mean(tl)), "val_loss": vl})
        log_fn(f"[unimodal ep {ep:02d}] train {np.mean(tl):.4f} | val {vl:.4f}")
        if vl < best - 1e-6:
            best, wait, plateau_wait = vl, 0, 0
            best_params = snapshot()
        else:
            wait += 1
            plateau_wait += 1
            if plateau_wait >= 2:  # ReduceLROnPlateau(factor=0.1, patience=2)
                lr_scale *= 0.1
                plateau_wait = 0
                log_fn(f"[unimodal] plateau: lr -> {lr_scale:.2e}")
            if wait >= patience:
                log_fn("[unimodal] early stopping")
                break
    model.load_state_dict(best_params)
    model.eval()
    return best_params, history


def _eval_and_fairness(model: nn.Module, feats, y, sens, tasks, dict_output: bool = True):
    """The whole split in one forward -> (metrics per task, fairness report
    per task where `sens` is given)."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        logits = _logits(model(torch.as_tensor(np.asarray(feats)).to(dev)), tasks, dict_output)
    logits = logits.float().cpu().numpy()
    probs = 1.0 / (1.0 + np.exp(-logits))
    y2 = _stack_y(np.asarray(y))
    metrics = {t: epoch_metrics(y2[:, i], probs[:, i]) for i, t in enumerate(tasks)}
    fair: Dict[str, Any] = {}
    if sens is not None:
        groups = {"sens": np.asarray(sens)}
        fair = {t: fairness_report(groups, y2[:, i], probs[:, i]) for i, t in enumerate(tasks)}
    return metrics, fair


def _note_encoder(cfg: Config, seed: int, device) -> nn.Module:
    """The frozen chunked BERT of the note trainer, in eval mode on `device`:
    built on the CPU under `seed`, then ``encoder.bert_weights`` where set."""
    from multimodalrouting_tpu_torch.models.clinbert import BioClinBERTEncoder
    from multimodalrouting_tpu_torch.models.full import compute_dtype, resolve_device
    from multimodalrouting_tpu_torch.pretrained import load_bert_weights

    e = cfg.encoder
    enc = _seeded(seed, lambda: BioClinBERTEncoder(
        d=e.d, note_agg=e.note_agg, chunk_agg=e.note_chunk_agg, gelu=e.bert_gelu, vocab_size=e.bert_vocab_size,
        hidden=e.bert_hidden, layers=e.bert_layers, heads=e.bert_heads, intermediate=e.bert_intermediate,
        max_position=e.bert_max_position, dtype=compute_dtype(cfg),
    ), "cpu")
    if e.bert_weights:  # 01_BioClinicalBert.py embeds with the real Bio_ClinicalBERT
        load_bert_weights(e.bert_weights, e.bert_layers, enc.bert)
    return enc.to(resolve_device(device)).eval()


def _embed_notes(enc: nn.Module, batches: List[Batch], batch_size: int) -> List[np.ndarray]:
    """`enc`'s pooled note embeddings [N, encoder.d], fp32 on the host, in
    minibatches of `batch_size` (the tail padded by repeating the last row
    and trimmed on the host, so every minibatch has one shape)."""
    dev = next(enc.parameters()).device
    bs = max(int(batch_size), 1)

    def sub_notes(b: Batch, idx: np.ndarray):
        return {"input_ids": torch.as_tensor(np.asarray(b.note_ids)[idx]).to(dev),
                "attention_mask": torch.as_tensor(np.asarray(b.note_attn)[idx]).to(dev),
                "chunk_mask": torch.as_tensor(np.asarray(b.chunk_mask)[idx]).to(dev)}

    out: List[np.ndarray] = []
    with torch.inference_mode():
        for b in batches:
            n = b.batch_size
            parts = []
            for start in range(0, n, bs):
                idx = np.minimum(np.arange(start, start + bs), n - 1)
                _, _, pooled = enc(sub_notes(b, idx))
                parts.append(pooled.float().cpu().numpy()[: min(bs, n - start)])
            out.append(np.concatenate(parts, axis=0))
    return out


def _write_reports(out_dir: Optional[str], modality: str, tasks, metrics, fair, history) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "unimodal_metrics.json"), "w") as f:
        json.dump({"modality": modality, "tasks": list(tasks), "metrics": metrics, "history": history},
                  f, indent=2, default=float)
    with open(os.path.join(out_dir, "fairness.json"), "w") as f:
        json.dump(fair, f, indent=2, default=float)


def train_unimodal(
    cfg: Config,
    train_b: Batch,
    val_b: Batch,
    test_b: Batch,
    *,
    modality: str = "behrt",  # behrt | note
    task: str = "mort",  # mort | readmit (behrt); the label source
    tasks: Optional[Tuple[str, ...]] = None,  # explicit task names (the INSPECT
    # impressions CSV's label columns) override the y-shape inference
    out_dir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> UnimodalResult:
    """Train one unimodal model on host batches and write its metrics and
    fairness JSON."""
    from multimodalrouting_tpu_torch.models.full import resolve_device

    t, e = cfg.train, cfg.encoder
    dev = resolve_device(device)
    y_tr, y_va = np.asarray(train_b.y), np.asarray(val_b.y)
    tasks = tuple(tasks) if tasks else _tasks_for(y_tr, task)
    y_te = np.asarray(test_b.y)

    if modality == "behrt":
        _, n_bins, n_labs = np.asarray(train_b.x_struct).shape
        model = _seeded(t.seed, lambda: WideBEHRTClassifier(
            n_bins=n_bins, n_labs=n_labs, d=e.d, n_layers=e.structured_layers, n_heads=e.structured_heads,
            tasks=tasks), dev)
        feats = [np.asarray(b.x_struct, np.float32).reshape(b.batch_size, -1) for b in (train_b, val_b, test_b)]
        dict_output = True
        # readmission trains on the focal loss, gamma 2.5 (02_BEHRT.py:106);
        # the 3-task trainer on the pos_weight BCE (01_BEHRT.py:170)
        loss_kind, focal_gamma = ("focal", 2.5) if task == "readmit" else ("pos_weight_bce", 2.5)
    elif modality == "note":
        feats = _embed_notes(_note_encoder(cfg, t.seed, dev), [train_b, val_b, test_b], t.batch_size)
        model = _seeded(t.seed, lambda: NoteEmbeddingClassifier(
            d_in=feats[0].shape[1], hidden=cfg.model.d, num_classes=len(tasks)), dev)
        dict_output = False
        loss_kind, focal_gamma = "focal", 2.0
    else:
        raise ValueError(f"Unknown unimodal modality {modality!r} (behrt|note)")

    params, history = _fit(
        model, feats[0], y_tr, feats[1], y_va,
        tasks=tasks, loss_kind=loss_kind, focal_gamma=focal_gamma,
        lr=t.lr, weight_decay=t.weight_decay, batch_size=t.batch_size,
        epochs=t.epochs, patience=t.early_stop_patience, seed=t.seed,
        log_fn=log_fn, dict_output=dict_output,
    )
    metrics, fair = _eval_and_fairness(model, feats[2], y_te, test_b.sens, tasks, dict_output=dict_output)
    for name, m in metrics.items():
        log_fn(f"[unimodal {modality}:{name}] AUROC {m.get('auroc', float('nan')):.4f} "
               f"F1 {m.get('f1', float('nan')):.4f}")
    _write_reports(out_dir, modality, tasks, metrics, fair, history)
    return UnimodalResult(params=params, metrics=metrics, fairness=fair, history=history)


class OMOPStacked(nn.Module):
    """One stacked id tensor [B, 3] (or [B, 3, T]) -> (proc, meas, drug) ->
    the OMOP concept model, named ``omop`` as the JAX adapter names it."""

    def __init__(self, vocab_sizes: Tuple[int, int, int], hidden: int, tasks: Sequence[str]):
        super().__init__()
        self.omop = OMOPConceptModel(*vocab_sizes, hidden=hidden, tasks=tasks)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.omop(x[:, 0], x[:, 1], x[:, 2], generator)


class CTMultitask(nn.Module):
    """CT volumes [B, S, H, W, 1] -> ``ct`` (a per-slice ResNet under
    GroupNorm, so no batch statistics) -> one ``head_{t}`` per task."""

    def __init__(self, hidden: int, backbone: str, tasks: Sequence[str]):
        super().__init__()
        self.tasks = tuple(tasks)
        self.ct = CTVolumeEncoder(d=hidden, backbone=backbone, norm_kind="group")
        for t in self.tasks:
            self.add_module(f"head_{t}", Dense(hidden, 1))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        z = self.ct(x, train=generator is not None)
        return {t: getattr(self, f"head_{t}")(z)[:, 0] for t in self.tasks}


def _fit_and_report(modality: str, model: nn.Module, data, pack, *, tasks, lr, weight_decay, batch_size,
                      epochs, patience, seed, out_dir, log_fn) -> UnimodalResult:
    """train_omop's and train_ct's shared body: fit on "train" / "val" over
    `tasks`, evaluate on "test", write the reports."""
    x_tr, y_tr = pack("train")
    x_va, y_va = pack("val")
    params, history = _fit(
        model, x_tr, y_tr, x_va, y_va,
        tasks=tasks, loss_kind="pos_weight_bce", focal_gamma=2.0,
        lr=lr, weight_decay=weight_decay, batch_size=batch_size,
        epochs=epochs, patience=patience, seed=seed, log_fn=log_fn,
    )
    x_te, y_te = pack("test")
    metrics, fair = _eval_and_fairness(model, x_te, y_te, data["test"].get("sens"), tasks)
    _write_reports(out_dir, modality, tasks, metrics, fair, history)
    return UnimodalResult(params=params, metrics=metrics, fairness=fair, history=history)


def train_omop(
    data: Dict[str, Dict[str, np.ndarray]],  # split -> {proc, meas, drug, y[B,K], sens?}
    *,
    vocab_sizes: Tuple[int, int, int],
    tasks: Tuple[str, ...] = INSPECT_TASKS,
    hidden: int = 128,
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    batch_size: int = 32,
    epochs: int = 20,
    patience: int = 5,
    seed: int = 0,
    out_dir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> UnimodalResult:
    """INSPECT's OMOP concept multitask trainer (INSPECT/BEHRT.py:62-90):
    splits "train" / "val" / "test" of concept-id arrays and labels
    [B, len(tasks)]."""
    from multimodalrouting_tpu_torch.models.full import resolve_device

    def pack(split):
        d = data[split]
        return np.stack([d["proc"], d["meas"], d["drug"]], axis=1).astype(np.int64), np.asarray(d["y"], np.float32)

    model = _seeded(seed, lambda: OMOPStacked(vocab_sizes, hidden, tasks), resolve_device(device))
    return _fit_and_report("omop", model, data, pack, tasks=tuple(tasks), lr=lr, weight_decay=weight_decay,
                             batch_size=batch_size, epochs=epochs, patience=patience, seed=seed, out_dir=out_dir,
                             log_fn=log_fn)


def train_ct(
    data: Dict[str, Dict[str, np.ndarray]],  # split -> {x[B,S,H,W,C], y[B,K], sens?}
    *,
    hidden: int = 128,
    backbone: str = "resnet18",
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    batch_size: int = 32,
    epochs: int = 20,
    patience: int = 5,
    seed: int = 0,
    out_dir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> UnimodalResult:
    """INSPECT's CT-volume multitask trainer: the CT branch of the reference's
    CXR/CT encoder switch (INSPECT/models/encoders.py:119-207, slice
    averaging at :198-206) with the four task heads of ``train_omop``."""
    from multimodalrouting_tpu_torch.models.full import resolve_device

    def pack(split):
        d = data[split]
        return np.asarray(d["x"], np.float32), np.asarray(d["y"], np.float32)

    model = _seeded(seed, lambda: CTMultitask(hidden, backbone, INSPECT_TASKS), resolve_device(device))
    return _fit_and_report("ct", model, data, pack, tasks=INSPECT_TASKS, lr=lr, weight_decay=weight_decay,
                             batch_size=batch_size, epochs=epochs, patience=patience, seed=seed, out_dir=out_dir,
                             log_fn=log_fn)
