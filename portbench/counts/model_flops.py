"""Model operations a stay needs, counted from shapes.

Only products are counted (2 operations a multiply-add: GEMMs,
convolutions, attention products); elementwise work, normalisation and
softmax are left out, so the count is the work a perfect program could not
avoid. Useful work only:

- the note encoder runs each of a stay's valid chunks at all of its
  positions (the chunk length), with attention over the chunk's valid keys;
  no padded pack slot and no empty chunk slot is counted;
- the labs encoder runs its 48 hours plus the CLS position, the image
  encoder the whole image;
- each MulT stream runs at its modality's own length (labs hours, the
  stay's valid chunks, the image's spatial tokens), not at the padded one;
- training counts the forward of every module and twice the forward of
  each trained one (the gradients of the inputs and of the weights); the
  frozen note encoder body is counted once, its projection as trained.

``stay_flops`` takes the configuration as the nested dict the
configuration files hold (``Config`` in dict form).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def _conv(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * c_in * c_out * k * k * h_out * w_out


def resnet_flops(backbone: str, image: int) -> Dict[str, float]:
    """The backbone's convolutions at an image of `image` pixels a side, and
    its output channels and spatial size."""
    stages = RESNET_STAGES[backbone]
    s = (image + 2 * 3 - 7) // 2 + 1  # conv1 7x7/2, padding 3
    total = _conv(3, 64, 7, s, s)
    s = (s + 2 * 1 - 3) // 2 + 1  # max pool 3/2, padding 1
    c_in = 64
    for stage, n_blocks in enumerate(stages):
        filters = 64 * 2**stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            s_out = (s + 2 - 3) // stride + 1
            total += _conv(c_in, filters, 3, s_out, s_out) + _conv(filters, filters, 3, s_out, s_out)
            if stride != 1 or c_in != filters:
                total += _conv(c_in, filters, 1, s_out, s_out)
            c_in, s = filters, s_out
    return {"flops": total, "channels": c_in, "side": s}


def _post_ln_layer(s: int, d: int, ffn: int) -> float:
    return 8.0 * s * d * d + 4.0 * s * d * ffn + 4.0 * s * s * d


def _mult_layer(tq: int, tk: int, d: int) -> float:
    return 4.0 * tq * d * d + 4.0 * tk * d * d + 16.0 * tq * d * d + 4.0 * tq * tk * d


def stay_flops(cfg: Mapping, valid_keys: Sequence[int]) -> Dict[str, float]:
    """Forward operations of one stay by part, `valid_keys` holding the
    valid key count of each of its valid note chunks."""
    e, m = cfg["encoder"], cfg["model"]
    d_enc, d = e["d"], m["d"]
    length, hidden, inter = e["text_max_len"], e["bert_hidden"], e["bert_intermediate"]
    chunks = len(valid_keys)
    bert = 0.0
    for keys in valid_keys:
        bert += e["bert_layers"] * (8.0 * length * hidden * hidden + 4.0 * length * hidden * inter
                                    + 4.0 * length * keys * hidden)
    note_proj = chunks * 2.0 * hidden * d_enc
    t, f = e["structured_seq_len"], e["structured_n_feats"]
    s = t + (1 if e["structured_pool"] == "cls" else 0)
    labs = 2.0 * t * f * d_enc + e["structured_layers"] * _post_ln_layer(s, d_enc, 4 * d_enc) + 2.0 * s * d_enc * d_enc
    res = resnet_flops(e["vision_backbone"], e["image_size"])
    tokens = res["side"] ** 2
    c = res["channels"]
    image = res["flops"] + 2.0 * c * e["vision_num_classes"] + 2.0 * c * d_enc + 2.0 * tokens * c * d_enc
    lengths = (t, chunks, tokens)  # L, N, I
    mult = sum(2.0 * n * d_enc * d for n in lengths)
    mult += sum(m["mult_self_layers"] * _mult_layer(n, n, d) for n in lengths)
    cross = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
    mult += sum(m["mult_layers"] * _mult_layer(lengths[q], lengths[kv], d) for q, kv in cross)
    mult += 3 * 2.0 * 2 * d * d + 2.0 * 3 * d * d
    routes, pc, mc, k = 10, m["pc_dim"], m["mc_caps_dim"], m["num_classes"]
    head = 2.0 * routes * d * (pc + 1) + 2.0 * routes * pc * k * mc + m["num_routing"] * 4.0 * routes * k * mc
    head += 2.0 * routes * k * pc + 2.0 * k * pc * mc + 2.0 * k * mc
    return {"note_body": bert, "note_proj": note_proj, "labs": labs, "image": image, "mult": mult, "head": head}


def train_flops(cfg: Mapping, valid_keys: Sequence[int]) -> float:
    """Forward and backward operations of one stay in a train step."""
    parts = stay_flops(cfg, valid_keys)
    total = sum(parts.values())
    trained = total if cfg["encoder"]["finetune_text"] else total - parts["note_body"]
    return total + 2.0 * trained


def serve_flops(cfg: Mapping, valid_keys: Sequence[int]) -> float:
    return sum(stay_flops(cfg, valid_keys).values())
