"""Route taxonomy registry and route-mask algebra (counterpart of
multimodalrouting_tpu/routes.py).

Two taxonomies: 7 routes ("L","N","I","LN","LI","NI","LNI") and 10 routes
("L","N","I","LN","NL","LI","IL","NI","IN","LNI"). Tensors indexed by route
follow the tuple order; availability masks come from modality presence.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

ROUTES_7: Tuple[str, ...] = ("L", "N", "I", "LN", "LI", "NI", "LNI")
ROUTES_10: Tuple[str, ...] = ("L", "N", "I", "LN", "NL", "LI", "IL", "NI", "IN", "LNI")

BLOCKS_7: Dict[str, Tuple[int, ...]] = {"uni": (0, 1, 2), "bi": (3, 4, 5), "tri": (6,)}
BLOCKS_10: Dict[str, Tuple[int, ...]] = {"uni": (0, 1, 2), "bi": (3, 4, 5, 6, 7, 8), "tri": (9,)}

#: modalities required by each route (directional routes need both endpoints)
ROUTE_REQUIRES: Dict[str, Tuple[str, ...]] = {
    "L": ("L",), "N": ("N",), "I": ("I",),
    "LN": ("L", "N"), "NL": ("L", "N"),
    "LI": ("L", "I"), "IL": ("L", "I"),
    "NI": ("N", "I"), "IN": ("N", "I"),
    "LNI": ("L", "N", "I"),
}


def get_routes(taxonomy: str | int) -> Tuple[str, ...]:
    """The route tuple for taxonomy "7"/"10" (or 7/10)."""
    t = str(taxonomy)
    if t == "7":
        return ROUTES_7
    if t == "10":
        return ROUTES_10
    raise ValueError(f"Unknown route taxonomy {taxonomy!r}; expected 7 or 10")


def get_blocks(routes: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
    n = len(routes)
    if n == 7:
        return BLOCKS_7
    if n == 10:
        return BLOCKS_10
    arity = lambda k: tuple(i for i, r in enumerate(routes) if len(ROUTE_REQUIRES[r]) == k)  # noqa: E731
    return {"uni": arity(1), "bi": arity(2), "tri": arity(3)}


def route_mask_from_presence(
    has_l: torch.Tensor, has_n: torch.Tensor, has_i: torch.Tensor, routes: Sequence[str]
) -> torch.Tensor:
    """[B, R] float mask: a route is available iff every modality it needs is present."""
    has = {"L": has_l.float(), "N": has_n.float(), "I": has_i.float()}
    cols = []
    for r in routes:
        m = torch.ones_like(has["L"])
        for mod in ROUTE_REQUIRES[r]:
            m = m * has[mod]
        cols.append(m)
    return torch.clamp(torch.stack(cols, dim=-1), 0.0, 1.0)


def block_mask_for_stage(stage: str, routes: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(route_mask [R], block_mask [3]) of an sMRO curriculum stage: uni keeps
    the unimodal routes and block, bi adds the bimodal ones, tri keeps all."""
    blocks = get_blocks(routes)
    if stage == "uni":
        idx, bm = blocks["uni"], [1.0, 0.0, 0.0]
    elif stage == "bi":
        idx, bm = blocks["uni"] + blocks["bi"], [1.0, 1.0, 0.0]
    elif stage == "tri":
        idx, bm = blocks["uni"] + blocks["bi"] + blocks["tri"], [1.0, 1.0, 1.0]
    else:
        raise ValueError(f"Invalid stage {stage!r}; expected uni/bi/tri")
    rm = torch.zeros(len(routes), dtype=torch.float32)
    rm[list(idx)] = 1.0
    return rm, torch.tensor(bm, dtype=torch.float32)
