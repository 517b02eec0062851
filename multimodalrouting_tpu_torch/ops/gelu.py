"""BERT FFN activation variants (encoder.bert_gelu); counterpart of
multimodalrouting_tpu/ops/gelu.py.

"poly" is exact GELU with erf evaluated as the odd polynomial t * q(t^2)
(degree 9 in t^2, fitted on [0, 3], |err| <= 1.9e-5 there, +-1 outside) in
float32 — the same coefficients as the JAX package. "erf" is exact GELU and
"tanh" the tanh approximation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GELU_MODES = ("erf", "tanh", "poly")

_ERF_Q_COEF = (
    1.128358228394435,
    -0.375934855406094,
    0.11232725974952266,
    -0.02623957851832961,
    0.00479421605457915,
    -0.0006719141369009443,
    6.89873418638141e-05,
    -4.820208313091374e-06,
    2.0238708684626765e-07,
    -3.821079094377509e-09,
)
_ERF_BOUND = 3.0
_INV_SQRT2 = 0.7071067811865476


def erf_poly(t: torch.Tensor) -> torch.Tensor:
    """Polynomial erf, float32 in and out."""
    tc = torch.clamp(t, -_ERF_BOUND, _ERF_BOUND)
    u = tc * tc
    q = torch.full_like(u, _ERF_Q_COEF[-1])
    for c in _ERF_Q_COEF[-2::-1]:
        q.mul_(u).add_(c)  # Horner step in place: no new [N, F] buffer per term
    y = tc * q
    one = torch.ones_like(y)
    return torch.where(t > _ERF_BOUND, one, torch.where(t < -_ERF_BOUND, -one, y))


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU through the polynomial erf; float32 inside, x's dtype out."""
    xf = x.float()
    return (0.5 * xf * (1.0 + erf_poly(xf * _INV_SQRT2))).to(x.dtype)


def apply_gelu(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "poly":
        return gelu_poly(x)
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")
