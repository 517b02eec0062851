"""Interpretability sweep and inference demo of the gated-concat family
(counterpart of multimodalrouting_tpu/audit/sweep.py).

- The inference demo (reference MIMIC-IV/Model/inference_demo.py:152-233):
  each sample's route gates sorted, and the uni / bi / tri block means.
- The sweep (reference MIMIC-IV/Model/interpretability.py:189-348,
  collect_contributions and uc_bi_ti_for_batch): per-route occlusion
  contributions and UC/BI/TI, as a tidy table.

Both re-run only the light head path (fusion -> gates -> concat -> head)
around the encoders' pooled outputs, with the gated model's own submodules
(``fusion``, ``gate_net``, ``final_head``) in eval mode: the learned gate
(``model.gate_mode=learned``, as the JAX sweep reads ``params["gate_net"]``).
The seven occlusions are one head call and each UC/BI/TI draw another
(``audit/attribution.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from multimodalrouting_tpu_torch.audit.attribution import (
    block_weights_from_gates,
    compute_uc_bi_ti,
    route_contributions_occlusion,
)
from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.routes import ROUTES_7
from multimodalrouting_tpu_torch.routing.gates import concat_routes


def head_forward_from_pooled(cfg: Config, model, zl, zn, zi, avail: Optional[torch.Tensor] = None):
    """(zL, zN, zI) [B, d] -> (logits [B, K], gates [B, 7], route embedding
    stack [B, 7, d]) through `model`'s fusion, gate net and final head. Rows
    beyond `avail`'s B (stacked copies of the batch) take its rows in turn."""
    if getattr(model, "gate_net", None) is None:
        raise ValueError("the sweep needs the gated model's learned gate (model.gate_mode=learned)")
    if avail is not None and avail.shape[0] != zl.shape[0]:
        avail = avail.repeat(zl.shape[0] // avail.shape[0], 1)
    route_embs = model.fusion(zl, zn, zi)
    gates = model.gate_net(zl, zn, zi, avail=avail)
    x_cat, _ = concat_routes(route_embs, gates, ROUTES_7, l2norm=cfg.model.l2norm_each)
    logits = model.final_head(x_cat)
    return logits, gates, torch.stack([route_embs[r] for r in ROUTES_7], dim=1)


def _first_label(x: torch.Tensor) -> torch.Tensor:
    """The first label's logits in fp32: UC/BI/TI sum them over the draws in
    fp32 whatever the compute dtype (the identity f = G + UC + BI + TI then
    holds to fp32 rounding; at fp32 compute this is the JAX sweep's sum)."""
    return (x[:, 0] if x.dim() == 2 else x).float()


def gated_model_sweep(
    cfg: Config,
    model,
    pooled: Dict[str, object],
    avail=None,
    *,
    n_mc: int = 20,
    generator: Optional[torch.Generator] = None,
    permutations=None,
) -> Dict[str, np.ndarray]:
    """Occlusion contributions and UC/BI/TI from the pooled embeddings
    (``ModelOutput.pooled``: "L", "N", "I" [B, d]) of a gated-concat `model`
    in eval mode. The permutations come from `generator` (seed 0 by
    default) unless given ([n_mc, 3, B]). -> fp32 numpy arrays."""
    dev = next(model.parameters()).device
    zl, zn, zi = (torch.as_tensor(pooled[k], device=dev) for k in ("L", "N", "I"))
    if avail is not None:
        avail = torch.as_tensor(avail, device=dev)
    if generator is None and permutations is None:
        generator = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        logits, gates, stack = head_forward_from_pooled(cfg, model, zl, zn, zi, avail)
        contrib = route_contributions_occlusion(lambda x: _first_label(model.final_head(x)), stack, gates)
        uc, bi, ti = compute_uc_bi_ti(
            lambda l, n, i: _first_label(head_forward_from_pooled(cfg, model, l, n, i, avail)[0]),
            zl, zn, zi, generator=generator, n_mc=n_mc, permutations=permutations,
        )
        blocks = block_weights_from_gates(gates, ROUTES_7)
        emb_norm = torch.linalg.vector_norm(stack.float(), dim=-1)

    def f32(x):
        return x.float().cpu().numpy()

    return {
        "logits": f32(logits),
        "gates": f32(gates),
        "route_contrib": f32(contrib),
        "route_emb_norm": f32(emb_norm),
        "uc": f32(uc),
        "bi": f32(bi),
        "ti": f32(ti),
        "block_uni": f32(blocks["uni"]),
        "block_bi": f32(blocks["bi"]),
        "block_tri": f32(blocks["tri"]),
    }


def sweep_to_rows(sweep: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
    """Tidy per-sample rows (gate__r, route_contrib__r, route_emb_norm__r,
    UC/BI/TI, block means) — interpretability.py:240-257 DataFrame parity."""
    n = len(sweep["logits"])
    rows = []
    for i in range(n):
        row: Dict[str, float] = {
            "logit": float(np.ravel(sweep["logits"][i])[0]),
            "uc": float(np.ravel(sweep["uc"][i])[0]) if np.ndim(sweep["uc"][i]) else float(sweep["uc"][i]),
            "bi": float(np.ravel(sweep["bi"][i])[0]) if np.ndim(sweep["bi"][i]) else float(sweep["bi"][i]),
            "ti": float(np.ravel(sweep["ti"][i])[0]) if np.ndim(sweep["ti"][i]) else float(sweep["ti"][i]),
            "block_uni": float(sweep["block_uni"][i]),
            "block_bi": float(sweep["block_bi"][i]),
            "block_tri": float(sweep["block_tri"][i]),
        }
        for j, r in enumerate(ROUTES_7):
            row[f"gate__{r}"] = float(sweep["gates"][i, j])
            row[f"route_contrib__{r}"] = float(np.ravel(sweep["route_contrib"][i, j])[0])
            row[f"route_emb_norm__{r}"] = float(sweep["route_emb_norm"][i, j])
        rows.append(row)
    return rows


def print_inference_demo(sweep: Dict[str, np.ndarray], k: int = 5) -> str:
    """inference_demo.py printout: top routes per sample + block means."""
    lines = []
    gates = sweep["gates"]
    for i in range(min(k, len(gates))):
        order = np.argsort(-gates[i])
        top = ", ".join(f"{ROUTES_7[j]}={gates[i, j]:.3f}" for j in order)
        lines.append(f"sample {i}: logit={np.ravel(sweep['logits'][i])[0]:+.3f}  {top}")
    lines.append(
        "block means: uni={:.3f} bi={:.3f} tri={:.3f}".format(
            sweep["block_uni"].mean(), sweep["block_bi"].mean(), sweep["block_tri"].mean()
        )
    )
    out = "\n".join(lines)
    print(out)
    return out
