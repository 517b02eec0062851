"""Interpretability: occlusion route contributions and the UC/BI/TI
decomposition (counterpart of multimodalrouting_tpu/audit/attribution.py).

- ``route_contributions_occlusion`` (reference MIMIC-IV/Model/
  interpretability.py:212-239): zero one route's gate, re-run the head,
  record the logit change. The R occlusions run as one head call over an
  [R * B] stack, as the JAX package vmaps them over the route axis.
- ``compute_uc_bi_ti`` (reference routing.py:180-277, InteractionAttributor):
  Monte-Carlo permutation estimates of the unique (UC), pairwise (BI) and
  trimodal (TI) contributions. Each draw's seven expectations are one call
  of ``f`` over a [7 * B] stack, and the draws are summed in order, as the
  JAX package's ``lax.scan`` sums them. The permutations come from a
  ``torch.Generator`` or are given (``permutations`` [n_mc, 3, B]: the
  tests feed the JAX package's draws).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def route_contributions_occlusion(
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    route_embs_stack: torch.Tensor,  # [B, R, d]
    gates: torch.Tensor,  # [B, R]
) -> torch.Tensor:
    """Per-route logit deltas from zeroing each route's gate.

    head_fn maps the gated flat concat [N, R*d] -> logits [N] (or [N, K]).
    Returns [B, R] (or [B, R, K]): the full logit minus the occluded one.
    """
    b, r, d = route_embs_stack.shape
    g = gates.to(route_embs_stack.dtype)
    full = head_fn((g[..., None] * route_embs_stack).reshape(b, r * d))
    keep = 1.0 - torch.eye(r, dtype=g.dtype, device=g.device)  # [R (occluded), R]
    occluded = (g[None] * keep[:, None, :])[..., None] * route_embs_stack[None]  # [R, B, R, d]
    logits = head_fn(occluded.reshape(r * b, r * d))
    deltas = full[None] - logits.reshape(r, b, *logits.shape[1:])  # [R, B] or [R, B, K]
    return torch.movedim(deltas, 0, 1)


def draw_permutations(b: int, n_mc: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[n_mc, 3, B] row permutations (L, N, I per draw) from `generator`."""
    return torch.stack([torch.stack([torch.randperm(b, generator=generator) for _ in range(3)])
                        for _ in range(n_mc)])


def compute_uc_bi_ti(
    f: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    l: torch.Tensor,
    n: torch.Tensor,
    i: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    n_mc: int = 20,
    permutations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monte-Carlo UC/BI/TI decomposition of f(L, N, I) -> [B] (or [B, K]).

    ``f`` is row-wise: it takes [M * B, ...] inputs (M stacked copies of the
    batch) and returns [M * B] (or [M * B, K]). UC = the sum of the unique
    main effects, BI = the sum of the pairwise interactions, TI = the
    trimodal residual; f(obs) = G + UC + BI + TI by construction.
    """
    b = l.shape[0]
    if permutations is None:
        permutations = draw_permutations(b, n_mc, generator)
    permutations = torch.as_tensor(permutations, dtype=torch.long)
    if permutations.shape[1:] != (3, b):
        raise ValueError(f"permutations must be [n_mc, 3, {b}], got {tuple(permutations.shape)}")
    n_mc = permutations.shape[0]
    full = f(l, n, i)
    sums = [full * 0.0 for _ in range(7)]
    for p_l, p_n, p_i in permutations.to(l.device):
        pl, pn, pi = l[p_l], n[p_n], i[p_i]
        # E_all, hold L, hold N, hold I, keep LN, keep LI, keep NI
        combos = ((pl, pn, pi), (l, pn, pi), (pl, n, pi), (pl, pn, i), (l, n, pi), (l, pn, i), (pl, n, i))
        vals = f(*(torch.cat(xs, 0) for xs in zip(*combos))).reshape(7, b, *full.shape[1:])
        sums = [s + v for s, v in zip(sums, vals)]
    g, e_l, e_n, e_i, e_ln, e_li, e_ni = (s / n_mc for s in sums)
    u_l, u_n, u_i = e_l - g, e_n - g, e_i - g
    uc = u_l + u_n + u_i
    p_ln = e_ln - g - u_l - u_n
    p_li = e_li - g - u_l - u_i
    p_ni = e_ni - g - u_n - u_i
    bi = p_ln + p_li + p_ni
    ti = full - (g + uc + bi)
    return uc, bi, ti


def block_weights_from_gates(gates: torch.Tensor, routes) -> Dict[str, torch.Tensor]:
    """Uni / bi / tri block gate mass per sample (interpretability.py:240)."""
    from multimodalrouting_tpu_torch.routes import get_blocks

    return {name: gates[:, list(idx)].sum(dim=1) for name, idx in get_blocks(routes).items()}
