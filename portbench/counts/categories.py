"""Kernel categories of a device trace.

Frozen copy of ``scripts/torch_trace_report.py``'s ``CATEGORIES`` and
``category`` (the first pattern that matches a kernel's name wins).
"""
from __future__ import annotations

import re

CATEGORIES = (
    ("attention (K1, K2, K4)", r"attn::"),
    ("capsule routing (K3)", r"capsule_routing"),
    ("normalization", r"layer_norm|batch_norm|group_norm|LayerNorm|BatchNorm|GroupNorm|bn_fw|bn_bw"),
    ("convolution", r"fprop|dgrad|wgrad|conv|winograd|cudnn|nchwToNhwc|nhwcToNchw"),
    ("gemm", r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK"),
    ("reduction", r"reduce|Reduce|softmax|SoftMax|cumsum|scan"),
    ("copies", r"Memcpy|Memset|copy|Copy|CatArray|index|gather|scatter"),
    ("elementwise", r"elementwise|Functor|foreach|multi_tensor_apply"),
)

# the profiler names of the packed attention kernels (the port's csrc/)
K1_FORWARD = "attention_fwd_wgmma_kernel"
K2_PARTS = ("bwd_di_kernel", "bwd_dq_wgmma_kernel", "bwd_dkdv_wgmma_kernel")
# the optimizer's multi-tensor kernels (torch._foreach_*)
FOREACH = ("multi_tensor_apply", "foreach")


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "uncategorized"
