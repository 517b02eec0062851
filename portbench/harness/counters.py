"""The program's kernel launch counters, read around a traced window."""
from __future__ import annotations

from typing import Dict


def launches() -> Dict[str, int]:
    """K1's (packed attention forward) and K3's (fused capsule routing) launches so far."""
    from multimodalrouting_tpu_torch.ops.flash_packed import packed_attention
    from multimodalrouting_tpu_torch.ops.fused_capsule import capsule_routing_fused

    return {"K1": packed_attention.launches, "K3": capsule_routing_fused.launches}
