"""The plain reference of the first train steps, in float32.

From the weights the benchmark made, on the batches the program trained on:
the forward and loss of ``model.py`` (BatchNorm on batch statistics, no
dropout: every dropout rate of the configurations is 0), autograd, then the
update as the configuration states it: the gradient clipped to a global norm
of ``train.grad_clip`` over the trainable leaves, Adam (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias-corrected by the step count), plus
``train.weight_decay`` times the parameter, times minus the learning rate
(``train.lr`` for the head, ``train.encoder_lr`` for the encoders).

``reference_steps`` returns what the comparison reads: each step's loss,
each trainable leaf's gradient norm as the optimizer got it at step 1
(after the clip), and each leaf's change over the steps.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from . import model as ref

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def reference_steps(P0: Mapping[str, torch.Tensor], cfg: Mapping, batches: Sequence[Mapping[str, torch.Tensor]],
                    nx: ref.Numerics) -> Dict[str, object]:
    """Train from `P0` (float32 parameters and BatchNorm statistics) on each
    of `batches` in turn."""
    t = cfg["train"]
    P = {n: v.detach().clone().float() for n, v in P0.items()}
    names = [n for n in ref.param_shapes(cfg) if ref.trainable(cfg, n)]
    for n in names:
        P[n].requires_grad_(True)
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        out = ref.forward(nx, P, cfg, batch, train=True)
        loss = ref.task_loss(cfg, out["logits"], batch["y"])
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(P[n]) if g is None else g for n, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if not bool(g_norm < t["grad_clip"]):
                grads = [g / g_norm * t["grad_clip"] for g in grads]
            if step == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                mu[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[n].mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
                update = (mu[n] / (1.0 - ADAM_B1**step)) / (torch.sqrt(nu[n] / (1.0 - ADAM_B2**step)) + ADAM_EPS)
                update = update + t["weight_decay"] * P[n]
                lr = t["encoder_lr"] if n.startswith("encoders.") else t["lr"]
                P[n].sub_(lr * update)
        del out, loss, grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(P[n] - P0[n].float())) for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
