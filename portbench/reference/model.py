"""The plain reference of the 10-route capsule model, in float32.

Written from the model's equations, on tensors and a flat dict of named
parameters, with nothing of the program imported: the benchmark makes the
weights (``param_shapes`` names every leaf, in the program's state_dict
names) and hands the same ones to both sides. No kernel, no packing, no
cache: BERT runs each valid note chunk alone, attention is two products and
a softmax, the capsule routing is its three iterations written out.

``Numerics`` decides the precision: float32 with TF32 off (``Numerics()``),
or, as the correctness control, float8 e4m3 with one scale per tensor
(``Numerics("fp8")``) wherever the program holds a tensor in its
bfloat16 compute type: every product's inputs and outputs, normalised,
activated, pooled and residual tensors, attention weights, and the
gradients that flow back through them. Statistics,
softmax, the routing iterations and the loss stay float32, as the
program's float32 islands do. That is the configuration's bfloat16 moved
one step down, the step a later change could be tempted to take. The
rounding passes the gradient straight through.

The equations (encoders, MulT, projector, priors, capsule head):

- notes: embeddings (word + position + type 0) -> LayerNorm (eps 1e-12) ->
  post-LN layers (self-attention with the key mask, exact GELU FFN) -> the
  CLS row -> LayerNorm (eps 1e-5) -> projection (no bias), one row a chunk,
  invalid chunks zeroed; the body takes no gradient unless
  ``encoder.finetune_text``;
- labs: input projection + learned positions, a CLS token, post-LN layers
  (ReLU FFN of 4d), LayerNorm -> Linear -> ReLU; the hours' rows;
- image: pixels / 255 normalised by the ImageNet mean and std, ResNet with
  BatchNorm (batch statistics, biased variance, in training; the running
  ones otherwise); the last feature map's tokens projected (no bias);
- absent modalities zeroed; every sequence row clamped to norm 20 (the
  encoders' pooled rows feed no route of this model and are not computed);
- MulT: bias-free projections, sequences padded to one length, 3 self and 6
  cross pre-LN streams (inputs scaled by sqrt(d) plus sinusoidal positions,
  the query's LayerNorm reused on cross keys and values, rows under the
  query mask zeroed after every block), masked mean pools, pair merges and
  the trimodal merge;
- per-route projector -> poses and sigmoid activations; priors masked by
  presence and clamped to [floor, ceiling]; capsule routing (softmax over
  labels, unit activations, 3 iterations); R-matrix (coefficients normalised
  over routes) -> pooled poses -> logits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ROUTES = ("L", "N", "I", "LN", "NL", "LI", "IL", "NI", "IN", "LNI")
REQUIRES = {"L": "L", "N": "N", "I": "I", "LN": "LN", "NL": "LN", "LI": "LI", "IL": "LI", "NI": "NI",
            "IN": "NI", "LNI": "LNI"}
CROSS = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
CROSS_NAMES = ("LN", "LI", "NL", "NI", "IL", "IN")
RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NEG = -1e9
E4M3_MAX = 448.0

Params = Mapping[str, torch.Tensor]


def _round_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


ROUNDING = {"bf16": _round_bf16, "fp8": _round_e4m3}


class _Held(torch.autograd.Function):
    """A tensor held in a narrower type both ways: the value, and the
    gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return rnd(x.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


class Numerics:
    """The precision: float32 (``Numerics()``), or ``low`` ("bf16" or
    "fp8") wherever the program holds its compute type."""

    def __init__(self, low: str = ""):
        self.low = low
        self.rnd = ROUNDING.get(low)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input: rounded, its gradient passed straight through
        (a weight's gradient reaches the optimizer unrounded)."""
        if self.rnd is None:
            return x
        return x + (self.rnd(x.detach()) - x).detach()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the program holds in its compute type, and its gradient."""
        return x if self.rnd is None else _Held.apply(x, self.rnd)

    def linear(self, x, w, b=None):
        return self.act(F.linear(self.q(x), self.q(w), b))

    def einsum(self, eq, *xs):
        """A product of rounded inputs; its output as the caller holds it."""
        return torch.einsum(eq, *(self.q(x) for x in xs))

    def conv(self, x, w, stride, pad):
        return self.act(F.conv2d(self.q(x), self.q(w), stride=stride, padding=pad))


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------


def _dense(out: Dict, name: str, d_in: int, d_out: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = (d_out, d_in)
    if bias:
        out[f"{name}.bias"] = (d_out,)


def _ln(out: Dict, name: str, d: int) -> None:
    out[f"{name}.weight"] = (d,)
    out[f"{name}.bias"] = (d,)


def param_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the 10-route MulT capsule model, by the program's
    state_dict name, with its shape."""
    e, m = cfg["encoder"], cfg["model"]
    d_enc, d, hidden = e["d"], m["d"], e["bert_hidden"]
    out: Dict[str, Tuple[int, ...]] = {}
    b = "encoders.behrt"
    out[f"{b}.pos"] = (1, e["structured_seq_len"], d_enc)
    _dense(out, f"{b}.input_proj", e["structured_n_feats"], d_enc)
    out[f"{b}.cls_token"] = (1, 1, d_enc)
    for i in range(e["structured_layers"]):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{b}.layer_{i}.attn.{p}", d_enc, d_enc)
        _ln(out, f"{b}.layer_{i}.ln1", d_enc)
        _dense(out, f"{b}.layer_{i}.fc1", d_enc, 4 * d_enc)
        _dense(out, f"{b}.layer_{i}.fc2", 4 * d_enc, d_enc)
        _ln(out, f"{b}.layer_{i}.ln2", d_enc)
    _ln(out, f"{b}.out_ln", d_enc)
    _dense(out, f"{b}.out_proj", d_enc, d_enc)
    t = "encoders.bbert.bert"
    out[f"{t}.word_embeddings.weight"] = (e["bert_vocab_size"], hidden)
    out[f"{t}.position_embeddings.weight"] = (e["bert_max_position"], hidden)
    out[f"{t}.token_type_embeddings.weight"] = (e["bert_type_vocab"], hidden)
    _ln(out, f"{t}.embed_ln", hidden)
    for i in range(e["bert_layers"]):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{t}.layer_{i}.attention.attn.{p}", hidden, hidden)
        _ln(out, f"{t}.layer_{i}.attention.ln", hidden)
        _dense(out, f"{t}.layer_{i}.intermediate", hidden, e["bert_intermediate"])
        _dense(out, f"{t}.layer_{i}.output", e["bert_intermediate"], hidden)
        _ln(out, f"{t}.layer_{i}.ln", hidden)
    _ln(out, "encoders.bbert.proj_ln", hidden)
    _dense(out, "encoders.bbert.proj", hidden, d_enc, bias=False)
    bb = "encoders.imgenc.backbone"
    out[f"{bb}.conv1.weight"] = (64, 3, 7, 7)
    _ln(out, f"{bb}.bn1", 64)
    c_in = 64
    for stage, n_blocks in enumerate(RESNET_STAGES[e["vision_backbone"]]):
        filters = 64 * 2**stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            name = f"{bb}.layer{stage + 1}_block{block}"
            out[f"{name}.conv1.weight"] = (filters, c_in, 3, 3)
            _ln(out, f"{name}.bn1", filters)
            out[f"{name}.conv2.weight"] = (filters, filters, 3, 3)
            _ln(out, f"{name}.bn2", filters)
            if stride != 1 or c_in != filters:
                out[f"{name}.downsample_conv.weight"] = (filters, c_in, 1, 1)
                _ln(out, f"{name}.downsample_bn", filters)
            c_in = filters
    _dense(out, "encoders.imgenc.chexpert_head", c_in, e["vision_num_classes"])
    _dense(out, "encoders.imgenc.proj", c_in, d_enc)
    _dense(out, "encoders.imgenc.token_proj", c_in, d_enc, bias=False)
    for mod in ("l", "n", "i"):
        _dense(out, f"mult.proj_{mod}", d_enc, d, bias=False)
    for name, g, layers in (("self_streams", 3, m["mult_self_layers"]), ("cross_streams", 6, m["mult_layers"])):
        s = f"mult.{name}"
        for i in range(layers):
            for ln in ("ln0", "ln1"):
                out[f"{s}.layer_{i}.{ln}.scale"] = (g, d)
                out[f"{s}.layer_{i}.{ln}.bias"] = (g, d)
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{s}.layer_{i}.attn.{p}.kernel"] = (g, d, d)
                out[f"{s}.layer_{i}.attn.{p}.bias"] = (g, d)
            out[f"{s}.layer_{i}.fc1.kernel"] = (g, d, 4 * d)
            out[f"{s}.layer_{i}.fc1.bias"] = (g, 4 * d)
            out[f"{s}.layer_{i}.fc2.kernel"] = (g, 4 * d, d)
            out[f"{s}.layer_{i}.fc2.bias"] = (g, d)
        out[f"{s}.final_ln.scale"] = (g, d)
        out[f"{s}.final_ln.bias"] = (g, d)
    for pair in ("ln", "li", "ni"):
        _dense(out, f"mult.proj_pair_{pair}", 2 * d, d)
    _dense(out, "mult.final_lni", 3 * d, d)
    r, pc, mc, k = len(ROUTES), m["pc_dim"], m["mc_caps_dim"], m["num_classes"]
    out["projector.kernel"] = (r, d, pc + 1)
    out["projector.bias"] = (r, pc + 1)
    out["capsule_head.w"] = (r, pc, k, mc)
    out["capsule_head.pose_to_mc.weight"] = (mc, pc)
    out["capsule_head.embedding"] = (k, mc)
    out["capsule_head.bias"] = (k,)
    return out


def is_bn(name: str) -> bool:
    leaf = name.rsplit(".", 2)[-2]
    return name.startswith("encoders.imgenc.backbone.") and (leaf.startswith("bn") or leaf == "downsample_bn")


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _norm_act(nx, x, w, b, eps):
    """LayerNorm of a residual sum, both held in the compute type."""
    return nx.act(_layer_norm(nx.act(x), w, b, eps))


def _attention(nx: Numerics, q, k, v, key_mask, heads: int):
    """q [N, Tq, D] (scaled), k/v [N, Tk, D], key_mask [N, Tk] -> [N, Tq, D]."""
    n, tq, d = q.shape
    tk = k.shape[1]
    dh = d // heads
    qh = q.reshape(n, tq, heads, dh)
    kh = k.reshape(n, tk, heads, dh)
    vh = v.reshape(n, tk, heads, dh)
    logits = nx.einsum("nqhd,nkhd->nhqk", qh, kh)
    logits = logits.masked_fill(~key_mask.bool()[:, None, None, :], NEG)
    p = nx.act(torch.softmax(logits, dim=-1))
    return nx.act(nx.einsum("nhqk,nkhd->nqhd", p, vh)).reshape(n, tq, d)


def _mha(nx, P, pre, x_q, x_kv, key_mask, heads):
    d = x_q.shape[-1]
    q = nx.linear(x_q, P[f"{pre}.q_proj.weight"], P[f"{pre}.q_proj.bias"]) * (d // heads) ** -0.5
    k = nx.linear(x_kv, P[f"{pre}.k_proj.weight"], P[f"{pre}.k_proj.bias"])
    v = nx.linear(x_kv, P[f"{pre}.v_proj.weight"], P[f"{pre}.v_proj.bias"])
    o = _attention(nx, q, k, v, key_mask, heads)
    return nx.linear(o, P[f"{pre}.out_proj.weight"], P[f"{pre}.out_proj.bias"])


def _bert_layer(nx, P, pre, x, mask, heads):
    x = _norm_act(nx, x + _mha(nx, P, f"{pre}.attention.attn", x, x, mask, heads),
            P[f"{pre}.attention.ln.weight"], P[f"{pre}.attention.ln.bias"], 1e-12)
    h = nx.act(F.gelu(nx.linear(x, P[f"{pre}.intermediate.weight"], P[f"{pre}.intermediate.bias"])))
    h = nx.linear(h, P[f"{pre}.output.weight"], P[f"{pre}.output.bias"])
    return _norm_act(nx, x + h, P[f"{pre}.ln.weight"], P[f"{pre}.ln.bias"], 1e-12)


def bert_cls(nx: Numerics, P: Params, cfg: Mapping, ids: torch.Tensor, attn: torch.Tensor,
             recompute: bool = False) -> torch.Tensor:
    """The CLS row of BERT's last layer for chunks ids/attn [C, L] -> [C, H];
    `recompute` keeps only each layer's input for the backward."""
    e = cfg["encoder"]
    t = "encoders.bbert.bert"
    length = ids.shape[1]
    x = nx.act(P[f"{t}.word_embeddings.weight"][ids.long()] + P[f"{t}.position_embeddings.weight"][:length][None]
               + P[f"{t}.token_type_embeddings.weight"][0])
    x = _norm_act(nx, x, P[f"{t}.embed_ln.weight"], P[f"{t}.embed_ln.bias"], 1e-12)
    for i in range(e["bert_layers"]):
        pre, heads = f"{t}.layer_{i}", e["bert_heads"]
        if recompute and torch.is_grad_enabled():
            x = checkpoint(lambda x_, pre=pre: _bert_layer(nx, P, pre, x_, attn, heads), x, use_reentrant=False)
        else:
            x = _bert_layer(nx, P, pre, x, attn, heads)
    return x[:, 0]


def _sanitize(x: torch.Tensor, max_norm: float = 20.0) -> torch.Tensor:
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    norm = torch.sqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=1e-12))
    return x * torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))


def _masked_mean(x, mask):
    m = mask.to(x.dtype).unsqueeze(-1)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def notes(nx, P, cfg, batch, train: bool, chunk_block: int = 0):
    """(seq [B, S, d], chunk mask [B, S]) of the note encoder,
    BERT over the valid chunks only (in blocks of `chunk_block` chunks where
    no gradient flows through it)."""
    e = cfg["encoder"]
    ids, attn, cm = batch["note_ids"], batch["note_attn"], batch["chunk_mask"].float()
    b, s, length = ids.shape
    flat_ids, flat_attn = ids.reshape(b * s, length), attn.reshape(b * s, length)
    valid = torch.nonzero(cm.reshape(-1) > 0.5).reshape(-1)
    grad_body = train and e["finetune_text"]
    with torch.set_grad_enabled(grad_body and torch.is_grad_enabled()):
        if grad_body or not chunk_block:
            cls = bert_cls(nx, P, cfg, flat_ids[valid], flat_attn[valid], recompute=grad_body)
        else:
            blocks = [valid[i:i + chunk_block] for i in range(0, len(valid), chunk_block)]
            cls = torch.cat([bert_cls(nx, P, cfg, flat_ids[v], flat_attn[v]) for v in blocks])
    emb = _norm_act(nx, cls, P["encoders.bbert.proj_ln.weight"], P["encoders.bbert.proj_ln.bias"], 1e-5)
    emb = nx.linear(emb, P["encoders.bbert.proj.weight"])
    grid = emb.new_zeros((b * s, emb.shape[-1])).index_copy(0, valid, emb)
    h = grid.reshape(b, s, -1) * cm[..., None]
    return h, cm


def labs(nx, P, cfg, batch):
    e = cfg["encoder"]
    b_ = "encoders.behrt"
    x, mask = batch["x_struct"].float(), batch["m_struct"].float()
    b, t, _ = x.shape
    d = e["d"]
    h = nx.act(nx.linear(x, P[f"{b_}.input_proj.weight"], P[f"{b_}.input_proj.bias"]) + P[f"{b_}.pos"][:, :t])
    h = torch.cat([P[f"{b_}.cls_token"].expand(b, 1, d), h], dim=1)
    key_mask = torch.cat([torch.ones((b, 1), dtype=mask.dtype, device=mask.device), mask], dim=1)
    for i in range(e["structured_layers"]):
        pre = f"{b_}.layer_{i}"
        h = _norm_act(nx, h + _mha(nx, P, f"{pre}.attn", h, h, key_mask, e["structured_heads"]),
                P[f"{pre}.ln1.weight"], P[f"{pre}.ln1.bias"], 1e-5)
        f = nx.linear(F.relu(nx.linear(h, P[f"{pre}.fc1.weight"], P[f"{pre}.fc1.bias"])),
                      P[f"{pre}.fc2.weight"], P[f"{pre}.fc2.bias"])
        h = _norm_act(nx, h + f, P[f"{pre}.ln2.weight"], P[f"{pre}.ln2.bias"], 1e-5)
    h = _norm_act(nx, h, P[f"{b_}.out_ln.weight"], P[f"{b_}.out_ln.bias"], 1e-5)
    h = F.relu(nx.linear(h, P[f"{b_}.out_proj.weight"], P[f"{b_}.out_proj.bias"]))
    return h[:, 1:], mask


def _bn(nx, P, name, x, train: bool):
    w, bias = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return nx.act((x - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * w)[:, None, None] + bias[:, None, None])


def image(nx, P, cfg, batch, train: bool):
    e = cfg["encoder"]
    img, has_i = batch["image"], batch["has_i"].float()
    if img.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, device=img.device)
        std = torch.tensor(IMAGENET_STD, device=img.device)
        x = (img.float() / 255.0 - mean) / std * has_i[:, None, None, None]
    else:
        x = img.float()
    x = x.permute(0, 3, 1, 2)
    bb = "encoders.imgenc.backbone"
    x = F.relu(_bn(nx, P, f"{bb}.bn1", nx.conv(x, P[f"{bb}.conv1.weight"], 2, 3), train))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    c_in = 64
    for stage, n_blocks in enumerate(RESNET_STAGES[e["vision_backbone"]]):
        filters = 64 * 2**stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            name = f"{bb}.layer{stage + 1}_block{block}"
            y = F.relu(_bn(nx, P, f"{name}.bn1", nx.conv(x, P[f"{name}.conv1.weight"], stride, 1), train))
            y = _bn(nx, P, f"{name}.bn2", nx.conv(y, P[f"{name}.conv2.weight"], 1, 1), train)
            residual = x
            if stride != 1 or c_in != filters:
                down = nx.conv(x, P[f"{name}.downsample_conv.weight"], stride, 0)
                residual = _bn(nx, P, f"{name}.downsample_bn", down, train)
            x = F.relu(nx.act(residual + y))
            c_in = filters
    b, c, hh, ww = x.shape
    tokens = nx.linear(x.permute(0, 2, 3, 1).reshape(b, hh * ww, c), P["encoders.imgenc.token_proj.weight"])
    return tokens, torch.ones((b, hh * ww), device=x.device)


def sinusoidal(t: int, d: int, device) -> torch.Tensor:
    half = d // 2
    pos = torch.arange(1, t + 1, dtype=torch.float64, device=device)
    freqs = torch.exp(torch.arange(half, dtype=torch.float64, device=device) * -(math.log(10000.0) / (half - 1)))
    args = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1).float()


def _stacked_linear(nx, x, kernel, bias):
    """x [G, B, T, in] through G dense layers (kernel [G, in, out])."""
    return nx.act(nx.einsum("gbti,gio->gbto", x, kernel) + bias[:, None, None, :])


def _stacked_ln(nx, x, scale, bias):
    return nx.act(_layer_norm(x, None, None, 1e-5) * scale[:, None, None, :] + bias[:, None, None, :])


def _stream(nx, P, pre, layers, heads, x_in, q_mask, kv_in=None, kv_mask=None):
    """G MulT streams: queries x_in [G, B, T, d], for cross streams keys and
    values kv_in [G, B, Tk, d]."""
    g, b, t, d = x_in.shape
    qk = q_mask[..., None]
    x = nx.act(nx.act(math.sqrt(d) * x_in) + sinusoidal(t, d, x_in.device)) * qk
    cross = kv_in is not None
    if cross:
        xk = nx.act(nx.act(math.sqrt(d) * kv_in) + sinusoidal(kv_in.shape[2], d, x_in.device))
    for i in range(layers):
        lp = f"{pre}.layer_{i}"
        h = _stacked_ln(nx, x, P[f"{lp}.ln0.scale"], P[f"{lp}.ln0.bias"]) * qk
        kv = _stacked_ln(nx, xk, P[f"{lp}.ln0.scale"], P[f"{lp}.ln0.bias"]) if cross else h
        km = kv_mask if cross else q_mask
        q = _stacked_linear(nx, h, P[f"{lp}.attn.q_proj.kernel"], P[f"{lp}.attn.q_proj.bias"]) * (d // heads) ** -0.5
        k = _stacked_linear(nx, kv, P[f"{lp}.attn.k_proj.kernel"], P[f"{lp}.attn.k_proj.bias"])
        v = _stacked_linear(nx, kv, P[f"{lp}.attn.v_proj.kernel"], P[f"{lp}.attn.v_proj.bias"])
        tk = k.shape[2]
        o = _attention(nx, q.reshape(g * b, t, d), k.reshape(g * b, tk, d), v.reshape(g * b, tk, d),
                       km.reshape(g * b, tk), heads).reshape(g, b, t, d)
        o = _stacked_linear(nx, o, P[f"{lp}.attn.out_proj.kernel"], P[f"{lp}.attn.out_proj.bias"])
        x = nx.act(x + o) * qk
        h = _stacked_ln(nx, x, P[f"{lp}.ln1.scale"], P[f"{lp}.ln1.bias"]) * qk
        h = F.relu(_stacked_linear(nx, h, P[f"{lp}.fc1.kernel"], P[f"{lp}.fc1.bias"]))
        x = nx.act(x + _stacked_linear(nx, h, P[f"{lp}.fc2.kernel"], P[f"{lp}.fc2.bias"])) * qk
    return _stacked_ln(nx, x, P[f"{pre}.final_ln.scale"], P[f"{pre}.final_ln.bias"]) * qk


def mult(nx, P, cfg, seqs, masks):
    """The 10 route embeddings of the three modality sequences."""
    m = cfg["model"]
    heads = m["mult_heads"]
    projected = [nx.linear(s, P[f"mult.proj_{k}.weight"]) for s, k in zip(seqs, ("l", "n", "i"))]
    t = max(p.shape[1] for p in projected)
    padded = [F.pad(p, (0, 0, 0, t - p.shape[1])) for p in projected]
    mods = torch.stack([F.pad(mk.float(), (0, t - mk.shape[1])) for mk in masks])
    x = torch.stack(padded)
    h_self = _stream(nx, P, "mult.self_streams", m["mult_self_layers"], heads, x, mods)
    out = {k: _masked_mean(h_self[i], mods[i]) for i, k in enumerate(("L", "N", "I"))}
    qi = [q for q, _ in CROSS]
    ki = [kv for _, kv in CROSS]
    h_cross = _stream(nx, P, "mult.cross_streams", m["mult_layers"], heads, x[qi], mods[qi], x[ki], mods[ki])
    for g, name in enumerate(CROSS_NAMES):
        out[name] = _masked_mean(h_cross[g], mods[qi][g])
    e_ln = nx.linear(torch.cat([out["LN"], out["NL"]], -1), P["mult.proj_pair_ln.weight"], P["mult.proj_pair_ln.bias"])
    e_li = nx.linear(torch.cat([out["LI"], out["IL"]], -1), P["mult.proj_pair_li.weight"], P["mult.proj_pair_li.bias"])
    e_ni = nx.linear(torch.cat([out["NI"], out["IN"]], -1), P["mult.proj_pair_ni.weight"], P["mult.proj_pair_ni.bias"])
    out["LNI"] = nx.linear(torch.cat([e_ln, e_li, e_ni], -1), P["mult.final_lni.weight"], P["mult.final_lni.bias"])
    return out


def route_mask(batch) -> torch.Tensor:
    has = {"L": batch["has_l"].float(), "N": batch["has_n"].float(), "I": batch["has_i"].float()}
    return torch.stack([math.prod([has[c] for c in REQUIRES[r]]) for r in ROUTES], dim=-1)


def capsule_routing(nx, pose, act, w, iters: int):
    """Routing by agreement, softmax over the labels, unit activations:
    pose [B, R, A], act [B, R], w [R, A, K, D] -> coefficients [B, R, K]."""
    b, r, _ = pose.shape
    k, dm = w.shape[2], w.shape[3]
    votes = nx.einsum("bna,namd->bnmd", pose, w)
    next_pose = votes.sum(dim=1) / k  # the seed coefficients, 1 / K for every route and label
    next_act = act.mean(dim=1, keepdim=True).expand(b, k)
    votes_act = votes * act[:, :, None, None]
    coef = votes.new_full((b, r, k), 1.0 / k)
    for _ in range(iters):
        agree = nx.einsum("bnmd,bmd->bnm", votes, next_pose) / math.sqrt(dm)
        qk = torch.softmax(agree, dim=2) * next_act[:, None, :]
        coef = qk / (qk.sum(dim=2, keepdim=True) + 1e-10)
        next_pose = nx.einsum("bnm,bnmd->bmd", coef, votes_act)
        next_act = torch.ones((b, k), device=pose.device)
    return coef


def forward(nx: Numerics, P: Params, cfg: Mapping, batch: Mapping[str, torch.Tensor], train: bool,
            chunk_block: int = 0) -> Dict[str, torch.Tensor]:
    """-> logits [B, K], alpha [B, R] (the clamped priors) and r_matrix [B, R, K]."""
    m = cfg["model"]
    l_seq, l_mask = labs(nx, P, cfg, batch)
    n_seq, n_mask = notes(nx, P, cfg, batch, train, chunk_block)
    i_seq, i_mask = image(nx, P, cfg, batch, train)
    has_n, has_i = batch["has_n"].float(), batch["has_i"].float()
    n_seq, n_mask = n_seq * has_n[:, None, None], n_mask * has_n[:, None]
    i_seq, i_mask = i_seq * has_i[:, None, None], i_mask * has_i[:, None]
    seqs = [_sanitize(l_seq), _sanitize(n_seq), _sanitize(i_seq)]
    routes = mult(nx, P, cfg, seqs, [l_mask, n_mask, i_mask])
    x = torch.stack([routes[r] for r in ROUTES], dim=1)
    pc = m["pc_dim"]
    pc_all = nx.act(nx.einsum("brd,rdp->brp", x, P["projector.kernel"]) + P["projector.bias"][None])
    poses, acts = pc_all[:, :, :pc], nx.act(torch.sigmoid(pc_all[:, :, pc:]))[..., 0]
    rm = route_mask(batch)
    prior = acts * rm
    prior = torch.where(rm > 0, torch.clamp(prior, m["route_prior_floor"], m["route_prior_ceiling"]), prior)
    poses = poses * rm[..., None]
    alpha = prior * rm
    coef = capsule_routing(nx, poses, rm, P["capsule_head.w"], m["num_routing"])
    resp = coef * rm[..., None]
    r_matrix = resp / torch.clamp(resp.sum(dim=1, keepdim=True), min=1e-10)
    d_bkp = torch.einsum("brk,brp->bkp", r_matrix, poses)
    d_bkm = nx.linear(d_bkp, P["capsule_head.pose_to_mc.weight"])
    logits = nx.act(nx.einsum("bkm,km->bk", d_bkm, P["capsule_head.embedding"]) + P["capsule_head.bias"][None])
    return {"logits": logits, "alpha": alpha, "r_matrix": r_matrix}


def task_loss(cfg: Mapping, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Label-smoothed BCE: of the death logit (two-class mortality, the
    sqrt sampler: no pos_weight), or of every phenotype with the batch's
    clamped neg / pos ratio as pos_weight."""
    t, m = cfg["train"], cfg["model"]
    s = t["label_smoothing"]
    if m["task"] == "mort":
        logit, target, pw = logits[:, 1] - logits[:, 0], y.float(), None
    else:
        logit, target = logits, y.float()
        pos = torch.clamp(target.sum(dim=0), min=1.0)
        neg = torch.clamp((1.0 - target).sum(dim=0), min=1.0)
        lo, hi = t["pos_weight_clip"]
        pw = torch.clamp(neg / pos, lo, hi)
    target = target * (1.0 - s) + 0.5 * s
    pos_term = -target * F.logsigmoid(logit)
    if pw is not None:
        pos_term = pos_term * pw
    return (pos_term - (1.0 - target) * F.logsigmoid(-logit)).mean()


@contextlib.contextmanager
def fp32_products():
    """Products in float32 on the card: TF32 off for matmuls and cuDNN, the
    flags restored on exit."""
    found = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = found


def trainable(cfg: Mapping, name: str) -> bool:
    return cfg["encoder"]["finetune_text"] or not name.startswith("encoders.bbert.bert.")


def running_stat_names(shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, int]:
    """The running statistics buffers of every BatchNorm, with their size."""
    out = {}
    for n, s in shapes.items():
        if n.endswith(".weight") and len(s) == 1 and is_bn(n):
            base = n[: -len(".weight")]
            out[f"{base}.running_mean"] = s[0]
            out[f"{base}.running_var"] = s[0]
    return out


def chunk_valid_keys(batch: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The valid key count of every valid chunk, in row order."""
    cm = batch["chunk_mask"].reshape(-1) > 0.5
    return batch["note_attn"].reshape(cm.shape[0], -1)[cm].sum(dim=-1)
