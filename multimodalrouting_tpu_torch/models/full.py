"""The model families: encoders -> routes -> routing -> heads (counterpart
of multimodalrouting_tpu/models/full.py).

- ``CapsuleRoutingModel``: the flagship, 10 MulT routes (``MULTRouter``),
  10 per-route MulT stacks (``PerRouteMulTFusion``, ``model.bi_fusion_mode=
  mult``: the PhenoModel attention family) or 7 fused routes
  (``SevenRouteFusion``) -> projector -> priors -> ``CapsuleHead`` (K3 in
  softmax_out mode; the sigmoid gate runs the plain program);
- ``GatedConcatModel``: 7 routes -> per-route heads and gates (uniform,
  learned or loss_based) -> ``FinalConcatHead``; at the curriculum stages
  step1 / step2 the output is the stage's mean route logit;
- ``FAMEPlusPlus``: per-route heads over the concatenated member
  modalities -> the learned ``MMRouting`` gate or the loss-based EMA gate.

``models/baselines.py`` holds LateFusion and TriMF. Encoder outputs are
sanitized (nan_to_num and a row norm clamp at 20) and absent modalities are
zeroed and masked.

``forward(batch, train=...)`` is JAX's ``apply(..., train=...)``: in training
the dropouts draw from the ``generator`` it is given, BatchNorm uses batch
statistics and the output carries the new running statistics in
``batch_stats`` (state_dict keys), for the train step to commit.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.configs import Config
from multimodalrouting_tpu_torch.data.batches import Batch
from multimodalrouting_tpu_torch.models.behrt import BEHRTLabEncoder
from multimodalrouting_tpu_torch.models.clinbert import BioClinBERTEncoder
from multimodalrouting_tpu_torch.models.cxr import ImageEncoder, normalize_pixels
from multimodalrouting_tpu_torch.models.fusions import SevenRouteFusion
from multimodalrouting_tpu_torch.models.mult import MULTRouter
from multimodalrouting_tpu_torch.models.route_mult import PerRouteMulTFusion
from multimodalrouting_tpu_torch.routes import ROUTES_7, get_routes, route_mask_from_presence
from multimodalrouting_tpu_torch.routing.capsule_head import CapsuleHead, RoutePrimaryProjector, compose_priors
from multimodalrouting_tpu_torch.routing.gates import (
    FinalConcatHead,
    RouteGateNet,
    StackedRouteHeads,
    concat_routes,
    loss_based_gates,
    uniform_gates,
)
from multimodalrouting_tpu_torch.routing.smro import MMRouting, loss_based_fuse
from multimodalrouting_tpu_torch.train.losses import bce_with_logits
from multimodalrouting_tpu_torch.utils.profiling import annotate

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class EncodedModalities(NamedTuple):
    l_seq: torch.Tensor
    l_mask: torch.Tensor
    l_pool: torch.Tensor
    n_seq: torch.Tensor
    n_mask: torch.Tensor
    n_pool: torch.Tensor
    i_seq: torch.Tensor
    i_mask: torch.Tensor
    i_pool: torch.Tensor
    chexpert_logits: torch.Tensor


class ModelOutput(NamedTuple):
    logits: torch.Tensor  # [B,K]
    alpha: Optional[torch.Tensor] = None  # [B,R]
    r_matrix: Optional[torch.Tensor] = None  # [B,R,K]
    gates: Optional[torch.Tensor] = None  # [B,R] gate weights
    block_w: Optional[torch.Tensor] = None  # [B,3] sMRO block weights
    route_logits: Optional[torch.Tensor] = None  # [B,R,K] per-route logits
    route_embs: Optional[Dict[str, torch.Tensor]] = None
    pooled: Optional[Dict[str, torch.Tensor]] = None
    chexpert_logits: Optional[torch.Tensor] = None
    batch_stats: Optional[Dict[str, torch.Tensor]] = None  # training: new BatchNorm running statistics


def _sanitize(x: torch.Tensor, max_norm: float = 20.0) -> torch.Tensor:
    """NaN/Inf -> 0, then clamp each row's L2 norm at max_norm."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    norm = torch.sqrt(torch.clamp((x.float() ** 2).sum(dim=-1, keepdim=True), min=1e-12))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    return x * scale.to(x.dtype)


def compute_dtype(cfg: Config) -> torch.dtype:
    return DTYPES[cfg.model.dtype]


class TriEncoder(nn.Module):
    """The three modality encoders, sanitized outputs, presence gating."""

    def __init__(self, cfg: Config, dtype=torch.float32):
        super().__init__()
        e = cfg.encoder
        self.behrt = BEHRTLabEncoder(
            n_feats=e.structured_n_feats, d=e.d, seq_len=e.structured_seq_len,
            n_layers=e.structured_layers, n_heads=e.structured_heads, pool=e.structured_pool,
            dtype=dtype,
        )
        self.bbert = BioClinBERTEncoder(
            d=e.d, note_agg=e.note_agg, chunk_agg=e.note_chunk_agg, finetune_text=e.finetune_text,
            gelu=e.bert_gelu, ln=e.bert_ln, vocab_size=e.bert_vocab_size, hidden=e.bert_hidden,
            layers=e.bert_layers, heads=e.bert_heads, intermediate=e.bert_intermediate,
            max_position=e.bert_max_position, type_vocab=e.bert_type_vocab, dtype=dtype,
            dropout=e.dropout, pipeline=cfg.train.pipeline_parallel, int8=e.int8_text, remat=cfg.model.remat,
            pp_microbatches=cfg.train.pp_microbatches,
        )
        self.imgenc = ImageEncoder(
            d=e.d, vision_backbone=e.vision_backbone, vision_num_classes=e.vision_num_classes,
            norm_kind=e.vision_norm, dtype=dtype,
        )

    def forward(self, batch: Batch, train: bool = False, generator=None, note_pack: int = 0) -> EncodedModalities:
        with annotate("model.labs"):
            l_seq, l_mask, l_pool = self.behrt(batch.x_struct, batch.m_struct, generator)
        with annotate("model.notes", device=True):
            n_seq, n_mask, n_pool = self.bbert(batch.notes_dict(), generator, note_pack)
        with annotate("model.image"):
            i_seq, i_mask, i_pool, chexpert = self.imgenc(normalize_pixels(batch.image, batch.has_i), train)

        def gate(seq, mask, pool, has):
            h = has.to(seq.dtype)
            return seq * h[:, None, None], mask * has.to(mask.dtype)[:, None], pool * h[:, None]

        n_seq, n_mask, n_pool = gate(n_seq, n_mask, n_pool, batch.has_n)
        i_seq, i_mask, i_pool = gate(i_seq, i_mask, i_pool, batch.has_i)
        return EncodedModalities(
            l_seq=_sanitize(l_seq), l_mask=l_mask, l_pool=_sanitize(l_pool),
            n_seq=_sanitize(n_seq), n_mask=n_mask, n_pool=_sanitize(n_pool),
            i_seq=_sanitize(i_seq), i_mask=i_mask, i_pool=_sanitize(i_pool),
            chexpert_logits=chexpert,
        )


def seven_route_fusion(cfg: Config, dtype) -> SevenRouteFusion:
    m = cfg.model
    return SevenRouteFusion(
        d=m.d, d_in=cfg.encoder.d, feature_mode=m.fusion_feature_mode, bi_fusion_mode=m.bi_fusion_mode,
        tri_fusion_mode=m.tri_fusion_mode, p_drop=m.fusion_dropout, dtype=dtype,
    )


class CapsuleRoutingModel(nn.Module):
    """Flagship: TriEncoder -> MULTRouter (10 routes), PerRouteMulTFusion
    (10 routes, bi_fusion_mode=mult) or SevenRouteFusion (7 routes) ->
    projector -> priors -> CapsuleHead."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.routes = get_routes(m.routes)
        self.encoders = TriEncoder(cfg, dtype)
        d_enc = cfg.encoder.d
        self.per_route_mult = m.routes == "10" and m.bi_fusion_mode == "mult"
        if self.per_route_mult:
            self.route_mult = PerRouteMulTFusion(
                d=m.d, n_heads=m.mult_heads, layers=m.cross_attn_layers, attn_mask=m.cross_attn_mask,
                positions=m.mult_positions, dtype=dtype, attn_dropout=m.attn_dropout,
                relu_dropout=m.relu_dropout, res_dropout=m.res_dropout, embed_dropout=m.embed_dropout,
            )
        elif m.routes == "10":
            self.mult = MULTRouter(
                d_enc, d_enc, d_enc, d=m.d, num_heads=m.mult_heads, layers=m.mult_layers,
                self_layers=m.mult_self_layers, attn_mask=m.attn_mask, pool=m.mult_pool,
                positions=m.mult_positions, dtype=dtype, attn_dropout=m.attn_dropout,
                relu_dropout=m.relu_dropout, res_dropout=m.res_dropout, embed_dropout=m.embed_dropout,
            )
        else:
            self.fusion = seven_route_fusion(cfg, dtype)
        self.projector = RoutePrimaryProjector(
            self.routes, d_in=m.d, pc_dim=m.pc_dim,
            use_route_logit_bias=m.route_logit_bias_init != 0.0,
            interaction_bias_init=m.interaction_bias_init, prior_floor=m.projector_prior_floor,
            dtype=dtype,
        )
        self.capsule_head = CapsuleHead(
            num_routes=len(self.routes), pc_dim=m.pc_dim, mc_caps_dim=m.mc_caps_dim,
            num_classes=m.num_classes, num_routing=m.num_routing, head_style=m.head_style,
            routing_mode="sigmoid_routes" if m.capsule_act_type == "sigmoid_gate" else "softmax_out",
            act_type="ONES" if m.capsule_act_type != "EM" else "EM",
            uniform_routing=m.uniform_routing, gate_temp=m.gate_temp, gate_min=m.gate_min,
            gate_max=m.gate_max, dropout_rate=m.capsule_dropout, dtype=dtype,
        )

    def forward(
        self,
        batch: Batch,
        train: bool = False,
        route_mask: Optional[torch.Tensor] = None,
        detach_priors: Optional[bool] = None,
        act_temperature=None,
        generator: Optional[torch.Generator] = None,
        note_pack: int = 0,
    ) -> ModelOutput:
        """`train` selects the training forward (as JAX's apply); the route
        mask defaults to modality presence; `detach_priors` and `act_temperature` override the config
        (the train loop's warm-up and anneal); `note_pack` is the chunk-packing
        capacity (0: off). Dropout draws from `generator` in training only."""
        m = self.cfg.model
        gen = generator if train else None
        enc = self.encoders(batch, train, gen, note_pack)
        if route_mask is None:
            route_mask = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, self.routes)
        with annotate("model.routes"):
            if self.per_route_mult:
                route_embs = self.route_mult(
                    enc.l_seq, enc.l_mask, enc.l_pool, enc.n_seq, enc.n_mask, enc.n_pool,
                    enc.i_seq, enc.i_mask, enc.i_pool, generator=gen,
                )
            elif m.routes == "10":
                route_embs = self.mult(enc.l_seq, enc.n_seq, enc.i_seq, enc.l_mask, enc.n_mask, enc.i_mask,
                                       generator=gen)
            else:
                route_embs = self.fusion(enc.l_pool, enc.n_pool, enc.i_pool, gen)
        with annotate("model.head"):
            poses, acts = self.projector(route_embs)
            priors = compose_priors(
                acts, route_mask=route_mask,
                act_temperature=m.act_temperature if act_temperature is None else act_temperature,
                prior_floor=m.route_prior_floor, prior_ceiling=m.route_prior_ceiling,
                detach=m.detach_priors if detach_priors is None else detach_priors,
            )
            out = self.capsule_head(poses, priors, route_mask=route_mask, generator=gen)
        return ModelOutput(
            logits=out.logits.float(),
            alpha=out.alpha.float(),
            r_matrix=out.r_matrix.float(),
            route_embs=route_embs,
            pooled={"L": enc.l_pool, "N": enc.n_pool, "I": enc.i_pool},
            chexpert_logits=enc.chexpert_logits.float(),
            batch_stats=collect_batch_stats(self) if train else None,
        )


def _pooled(enc: EncodedModalities) -> Dict[str, torch.Tensor]:
    return {"L": enc.l_pool, "N": enc.n_pool, "I": enc.i_pool}


class GatedConcatModel(nn.Module):
    """7 routes -> per-route heads and gates -> FinalConcatHead over the
    gate-weighted concatenation."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.routes = ROUTES_7
        r = len(self.routes)
        self.encoders = TriEncoder(cfg, dtype)
        self.fusion = seven_route_fusion(cfg, dtype)
        self.route_heads = StackedRouteHeads(r, m.d, m.num_classes, p_drop=m.fusion_dropout, dtype=dtype)
        if m.gate_mode == "learned":  # the gate net's parameters exist only where the config learns it
            self.gate_net = RouteGateNet(3 * cfg.encoder.d, r, hidden=m.gate_hidden, p_drop=m.fusion_dropout,
                                         dtype=dtype)
        self.final_head = FinalConcatHead(r, m.d, m.num_classes, p_drop=m.fusion_dropout, dtype=dtype)

    def forward(
        self,
        batch: Batch,
        train: bool = False,
        gate_mode: Optional[str] = None,
        route_losses: Optional[torch.Tensor] = None,  # [B,R] for loss_based
        stage: str = "",  # "" | step1 | step2 | step3
        generator: Optional[torch.Generator] = None,
        note_pack: int = 0,
    ) -> ModelOutput:
        m = self.cfg.model
        gen = generator if train else None
        enc = self.encoders(batch, train, gen, note_pack)
        zl, zn, zi = enc.l_pool, enc.n_pool, enc.i_pool
        route_embs = self.fusion(zl, zn, zi, gen)
        route_logits = self.route_heads(torch.stack([route_embs[r] for r in self.routes], dim=1), gen)

        avail = route_mask_from_presence(batch.has_l, batch.has_n, batch.has_i, self.routes)
        mode = gate_mode or m.gate_mode
        if mode == "uniform":
            gates = uniform_gates(avail)
        elif mode == "loss_based":
            if route_losses is None:
                # per-sample per-route BCE of this forward's route logits, with
                # gradient: it flows through the gates, as in the reference
                y2 = batch.y if batch.y.dim() == 2 else batch.y[:, None]
                per = bce_with_logits(route_logits, y2[:, None, :].expand_as(route_logits), reduce=False)
                route_losses = per.mean(dim=-1)
            gates = loss_based_gates(route_losses, avail, alpha=m.gate_alpha)
        else:
            gates = self.gate_net(zl, zn, zi, avail=avail, generator=gen)

        x_cat, _ = concat_routes(route_embs, gates, self.routes, l2norm=m.l2norm_each)
        logits = self.final_head(x_cat, gen)
        # before step3 the final head is not trained: step1 and step2 output
        # the mean logit of the stage's route heads (unimodal, bimodal)
        if stage == "step1":
            logits = route_logits[:, :3, :].mean(dim=1)
        elif stage == "step2":
            logits = route_logits[:, 3:6, :].mean(dim=1)
        return ModelOutput(
            logits=logits.float(), gates=gates.float(), route_logits=route_logits.float(),
            route_embs=route_embs, pooled=_pooled(enc), chexpert_logits=enc.chexpert_logits.float(),
            batch_stats=collect_batch_stats(self) if train else None,
        )


class FAMEPlusPlus(nn.Module):
    """Per-route heads over the concatenated member modalities' embeddings
    (zero-padded to 3d) -> the learned MMRouting gate or the loss-based EMA
    gate (``model.smro_gate_mode``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.routes = ROUTES_7
        self.encoders = TriEncoder(cfg, dtype)
        self.route_heads = StackedRouteHeads(len(self.routes), 3 * m.d, m.num_classes, p_drop=m.smro_dropout,
                                             dtype=dtype)
        if m.smro_gate_mode != "loss_based":
            self.mm_routing = MMRouting(self.routes, 3 * cfg.encoder.d, gate_hidden=m.smro_gate_hidden,
                                        p_drop=m.smro_dropout, strict_freeze_gate=m.strict_freeze_gate,
                                        dtype=dtype)

    def forward(
        self,
        batch: Batch,
        train: bool = False,
        stage: Optional[str] = None,
        route_losses_ema: Optional[torch.Tensor] = None,  # [R] for loss_based
        generator: Optional[torch.Generator] = None,
        note_pack: int = 0,
    ) -> ModelOutput:
        m = self.cfg.model
        gen = generator if train else None
        enc = self.encoders(batch, train, gen, note_pack)
        pooled = _pooled(enc)
        feats = []
        for r in self.routes:
            x = torch.cat([pooled[mod] for mod in r], dim=-1)
            feats.append(F.pad(x, (0, 3 * m.d - x.shape[-1])))
        route_logits = self.route_heads(torch.stack(feats, dim=1), gen)
        if m.smro_gate_mode == "loss_based":
            if route_losses_ema is None:
                route_losses_ema = torch.zeros(len(self.routes), device=route_logits.device)
            out = loss_based_fuse(route_logits, route_losses_ema, m.smro_alpha, self.routes)
        else:
            out = self.mm_routing(route_logits, pooled["L"], pooled["N"], pooled["I"], stage=stage, generator=gen)
        return ModelOutput(
            logits=out.fused.float(), gates=out.route_w.float(), block_w=out.block_w.float(),
            route_logits=route_logits.float(), pooled=pooled, chexpert_logits=enc.chexpert_logits.float(),
            batch_stats=collect_batch_stats(self) if train else None,
        )


def collect_batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The new BatchNorm running statistics of the last training forward,
    by state_dict key (empty for GroupNorm models)."""
    out = {}
    for name, mod in model.named_modules():
        update = getattr(mod, "batch_update", None)
        if update is not None:
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = update
            mod.batch_update = None
    return out


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the CPU;
    asking for CUDA without a card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


FAMILIES = {"capsule": CapsuleRoutingModel, "gated_concat": GatedConcatModel, "fame": FAMEPlusPlus}


def build_model(cfg: Config, family: str = "capsule", *, device="cuda", train: bool = False) -> nn.Module:
    """The `family`'s model (capsule, gated_concat, fame, or the baselines
    late_fusion and trimf) on `device`, in eval mode, or in train mode with
    `train`. Parameters are fp32 masters; only under the frozen-text default with bf16
    compute and no int8 body is the BERT body held in bf16 (output-identical: the compute casts
    it to bf16 at every use anyway), layered or in the pipeline layout. A
    frozen body takes no gradient (JAX state.py:151-168); the int8 body
    quantizes its fp32 masters at every use."""
    from multimodalrouting_tpu_torch.models.baselines import BASELINES

    families = {**FAMILIES, **BASELINES}
    if family not in families:
        raise ValueError(f"Unknown model family {family!r}")
    e = cfg.encoder
    dev = resolve_device(device)
    model = families[family](cfg)
    if not e.finetune_text:
        model.encoders.bbert.bert.requires_grad_(False)
        if e.frozen_text_bf16 and not e.int8_text and compute_dtype(cfg) == torch.bfloat16:
            model.encoders.bbert.bert.to(torch.bfloat16)
    return model.to(dev).train(train)
