"""BERT FFN activation variants (encoder.bert_gelu); counterpart of
multimodalrouting_tpu/ops/gelu.py.

"poly" is exact GELU with erf evaluated as the odd polynomial t * q(t^2)
(degree 9 in t^2, fitted on [0, 3], |err| <= 1.9e-5 there, +-1 outside) in
float32 — the same coefficients as the JAX package. "erf" is exact GELU and
"tanh" the tanh approximation.

Under a gradient the poly GELU is ``PolyGelu``, an autograd Function that
saves only its input and, in the backward, recomputes the fp32 chain with
its derivative (the derivative of the same polynomial that JAX
differentiates). Autograd through the chain itself would either fail on the
in-place Horner steps or keep about ten fp32 copies of the [tokens, 3072]
FFN activation per BERT layer.
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


def _gelu_poly_forward(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (0.5 * xf * (1.0 + erf_poly(xf * _INV_SQRT2))).to(x.dtype)


def _gelu_poly_grad(xf: torch.Tensor) -> torch.Tensor:
    """d gelu_poly / dx in float32: 0.5 (1 + erf_poly(t)) + 0.5 x erf_poly'(t)
    / sqrt(2) with t = x / sqrt(2). Inside [-3, 3] erf_poly'(t) = q(u) +
    2 u q'(u) (u = t^2); outside, erf_poly is the constant +-1 (and the clip
    passes no gradient), so the derivative is 0."""
    t = xf * _INV_SQRT2
    inside = t.abs() <= _ERF_BOUND
    tc = torch.clamp(t, -_ERF_BOUND, _ERF_BOUND)
    u = tc * tc
    q = torch.full_like(u, _ERF_Q_COEF[-1])
    dq = torch.zeros_like(u)
    for c in _ERF_Q_COEF[-2::-1]:
        dq.mul_(u).add_(q)  # Horner for q'(u), one step behind q
        q.mul_(u).add_(c)
    erf = torch.where(t > _ERF_BOUND, 1.0, torch.where(t < -_ERF_BOUND, -1.0, tc * q))
    derf = torch.where(inside, q + 2.0 * u * dq, 0.0)
    return 0.5 * (1.0 + erf) + (0.5 * _INV_SQRT2) * xf * derf


class PolyGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_poly_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * _gelu_poly_grad(x.float())).to(x.dtype)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU through the polynomial erf; float32 inside, x's dtype out."""
    if torch.is_grad_enabled() and x.requires_grad:
        return PolyGelu.apply(x)
    return _gelu_poly_forward(x)


def apply_gelu(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "poly":
        return gelu_poly(x)
    return F.gelu(x, approximate="tanh" if mode == "tanh" else "none")
