"""A cell cut to tiny widths and sizes, to run the harness on the CPU.

The widths keep the packed attention's shape gate (BERT at 256 positions,
128 hidden, 2 heads of 64), so the program takes the K1 / K2 branch with
their plain versions on CPU tensors.
"""
from __future__ import annotations

import copy
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {
    "encoder": {"d": 48, "structured_seq_len": 16, "structured_n_feats": 16, "structured_layers": 1,
                "structured_heads": 4, "bert_hidden": 128, "bert_layers": 2, "bert_heads": 2,
                "bert_intermediate": 96, "bert_vocab_size": 2048, "bert_max_position": 256, "text_max_len": 256,
                "notes_max_chunks": 4, "image_size": 32, "vision_backbone": "resnet18"},
    "model": {"d": 48, "mult_layers": 1, "mult_self_layers": 1, "mult_heads": 4, "pc_dim": 8, "mc_caps_dim": 16},
}
TINY_TRAFFIC = {"batch": 4, "pool_batches": 4, "chunks": [1, 4], "last_chunk_len": [32, 256], "lab_hours": [10, 16],
                "pool": 16, "stays_per_request": [1, 4], "blocks": 8, "checked_requests": 3,
                "requests_per_s": 20.0}


def shrink(dtype: str = "float32", limits=None, finetune=None):
    """-> the `cell_overrides` of ``run_cell``: tiny widths, compute `dtype`,
    and `limits` and `finetune` (the note encoder trained or frozen) in place
    of the cell's where given."""

    def apply(cell):
        cell = copy.deepcopy(cell)
        for section, values in TINY.items():
            cell["config"][section].update(values)
        cell["config"]["model"]["dtype"] = dtype
        cell["traffic"].update({k: v for k, v in TINY_TRAFFIC.items() if k in cell["traffic"]})
        if limits:
            cell["limits"] = dict(limits)
        if finetune is not None:
            cell["config"]["encoder"]["finetune_text"] = finetune
        return cell

    return apply


def run_tiny(workload: str, seed: int = 3, dtype: str = "float32", hooks=None, limits=None, seconds: float = 0.5,
             finetune=None):
    from portbench.run import run_cell

    torch.manual_seed(0)
    return run_cell(workload, seed, seconds, False, torch.device("cpu"), cell_overrides=shrink(dtype, limits, finetune),
                    hooks=hooks)
