"""Typed config tree with YAML/JSON + env + CLI overrides.

The port's own copy of multimodalrouting_tpu/configs.py (importing that
module would configure JAX): the same schema, override rules and
serialisation, so a config dict moves between the two packages unchanged.

One immutable dataclass tree replaces the reference's per-variant mutable
``env_config.py`` module globals (reference:
MIMIC-IV/MortModel/Paired_Cross_Attention/env_config.py:69-181 for the knob
set, :345-511 for the MIMICIV_* env map, :514-586 for CLI overrides).
Knob names match the reference so users can carry configs across.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Leaf configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder knobs (reference: .../Paired_Cross_Attention/encoders.py:891-913)."""

    d: int = 256
    dropout: float = 0.0

    # structured (L)
    structured_seq_len: int = 48
    structured_n_feats: int = 76
    structured_layers: int = 2
    structured_heads: int = 8
    structured_pool: str = "cls"  # last | mean | cls

    # notes (N)
    text_model_name: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_len: int = 512
    notes_max_chunks: int = 8
    note_agg: str = "cls"  # cls | mean | max (token-level, per chunk)
    note_chunk_agg: str = "mean"  # mean | max (pooling over chunks)
    bert_hidden: int = 768
    bert_layers: int = 12
    bert_heads: int = 12
    bert_intermediate: int = 3072
    bert_vocab_size: int = 28996
    bert_max_position: int = 512
    bert_type_vocab: int = 2
    finetune_text: bool = False
    # run the frozen BERT body's matmuls on the MXU int8 path (2x bf16 peak
    # on v5e); inference-only so it requires finetune_text=False
    int8_text: bool = False
    # frozen-BERT bf16 at rest (PERF.md headroom item 2): when the text
    # encoder is frozen and compute dtype is bf16, store its ~110M params as
    # bf16 masters — compute is output-identical (fp32 masters are cast to
    # bf16 at every use anyway) and HBM residency halves (~220 MB on BERT
    # base). No effect when finetune_text/int8_text or fp32 compute.
    frozen_text_bf16: bool = True
    # chunk packing: run BERT only over the batch's VALID note chunks
    # (gathered into a bucketed static-capacity buffer — reference parity,
    # the torch code only encodes real chunks; see clinbert.note_pack_capacity)
    note_pack: bool = True
    # precompute the frozen BERT body's per-chunk embeddings ONCE per cohort
    # and train every epoch from the cache (train/text_cache.py) — the TPU
    # analogue of the reference's precomputed-embedding CSV workflow
    # (01_BioClinicalBert.py). Output-identical; removes ~85% of step compute
    # (PERF.md phase table) from every epoch after the first. Requires
    # finetune_text=False and a dense (non-streaming) split.
    text_embedding_cache: bool = False
    # BERT FFN activation lowering. "poly" (default) evaluates exact GELU
    # through a degree-9 minimax polynomial erf (ops/gelu.py): at the bf16
    # compute dtype it is MORE accurate than XLA's own erf lowering
    # (98.96% vs 97.54% of all bf16 codes match float64-exact GELU,
    # tests/test_gelu_poly.py) and ~16% faster whole-step (PERF.md "GELU
    # lowering"). "erf" is XLA's erf — bit-matching HF BertIntermediate at
    # fp32, which is what the golden-parity suites pin. "tanh" is the
    # coarser (~3e-3) standard approximation.
    bert_gelu: str = "poly"
    # BERT LayerNorm epilogue precision. "bf16" (default;
    # ops/layernorm.py FastLayerNorm) keeps the mean/variance REDUCTIONS
    # and rsqrt in fp32 but runs the per-element normalize+affine in the
    # compute dtype: at fp32 compute it matches flax to roundoff (same
    # fast-variance formula), at bf16 it trades ~2 bf16 ulps on values
    # that are ~N(0,1) post-normalize for +1.1% whole-step (PERF.md
    # "LN epilogue precision", 207.3 -> 209.6 same-chip). "fp32" is flax
    # nn.LayerNorm's all-fp32 normalize+affine chain. Same param tree
    # either way, so checkpoints/HF imports are knob-independent.
    bert_ln: str = "bf16"
    # pretrained note-encoder weights (reference: AutoModel.from_pretrained,
    # MortModel/encoders.py:241): a torch.save()d HF BertModel state_dict
    # path, or an HF repo/dir name resolvable by transformers. Spliced into
    # fresh init by pretrained.apply_pretrained (cast to the run's dtypes).
    bert_weights: str = ""

    # images (I)
    vision_backbone: str = "resnet34"
    vision_num_classes: int = 14
    vision_norm: str = "batch"  # batch | group
    image_size: int = 224
    # host-side CXR transform stack (data/images.py): "flagship" =
    # Grayscale+RandomAffine(10)+RandomCrop (main.py:907-925), "medfuse" =
    # RandomAffine(45)+CenterCrop (cxr_dataset.py:64-86)
    image_transform: str = "flagship"
    image_resize: int = 256  # shorter-side resize before crop
    # Ship decoded CXR pixels host->device as uint8 and run ToTensor +
    # Normalize(IMAGENET) inside the XLA program (models/cxr.py
    # normalize_pixels, fused into the stem conv): 4x less host RAM and
    # transfer per image, bit-identical normalized values. Applies to the
    # real-export path only (synthetic cohorts are float-native).
    image_uint8_transfer: bool = True
    # pretrained vision-backbone weights (reference: torchvision
    # pretrained=True, MortModel/encoders.py:394): path to a torch.save()d
    # state_dict of the torchvision model named by vision_backbone (ImageNet
    # or MedFuse-finetuned). Requires vision_norm=batch (BN running stats).
    vision_weights: str = ""


@dataclass(frozen=True)
class ModelConfig:
    """Routing/fusion/head knobs (reference: env_config.py:70-179)."""

    d: int = 256
    routes: str = "10"  # "7" | "10"
    task: str = "mort"  # mort | pheno | multitask
    num_classes: int = 2  # 2 for mort capsule, 25 for pheno, 1 per-task heads

    # MulT directional streams (reference: mult_model.py:7-58)
    mult_layers: int = 4
    mult_self_layers: int = 2
    mult_heads: int = 8
    attn_dropout: float = 0.1
    relu_dropout: float = 0.1
    res_dropout: float = 0.1
    embed_dropout: float = 0.1
    attn_mask: bool = False
    mult_pool: str = "mean"  # mean | last (masked stream pooling)
    mult_positions: str = "sinusoidal"  # sinusoidal | ref_quantized (replicate
    # the reference's integer-truncated position table, a defect — see
    # models/attention.py:sinusoidal_positions)

    # capsule routing (reference: env_config.py pc/mc knobs; capsule_layers.py)
    pc_dim: int = 32
    mc_caps_dim: int = 64
    num_routing: int = 3
    capsule_act_type: str = "ONES"  # ONES | EM | sigmoid_gate
    capsule_dropout: float = 0.0
    # sigmoid-gate anti-collapse clamps (reference: PhenoModel/
    # capsule_atten.py:107-124 _apply_gate_temp_and_clamp)
    gate_temp: float = 1.0
    gate_min: float = 0.0
    gate_max: float = 1.0
    head_style: str = "rmatrix"  # rmatrix | class_linear | class_embed
    uniform_routing: bool = False

    # route priors (reference: routing_and_heads.py:316-352)
    act_temperature: float = 1.0
    # annealed warmup: start value decaying to act_temperature over N epochs
    # (reference MortModel/main.py act temperature 2.0 -> 1.0); 0 = disabled
    act_temperature_start: float = 0.0
    act_temperature_epochs: int = 0
    route_prior_floor: float = 0.02
    route_prior_ceiling: float = 0.98
    # projector-level floor clamp applied to activations BEFORE the bridge's
    # temperature, matching the 7-route MortModel projector
    # (MortModel/routing_and_heads.py:209-212); 0 = disabled (PCA semantics)
    projector_prior_floor: float = 0.0
    detach_priors: bool = False
    route_logit_bias_init: float = 0.0  # logit(0.30) for interactions in MortModel
    interaction_bias_init: float = -0.8472978603872037

    # gated-concat path (reference: Model/routing_and_heads.py:252-353)
    gate_mode: str = "learned"  # uniform | learned | loss_based
    gate_hidden: int = 1024
    gate_alpha: float = 1.0  # loss-based softmax(-alpha * per-route BCE)
    l2norm_each: bool = False

    # fusion family for the 7-route path; "mult" (with routes="10") selects
    # the per-route MulT family (models/route_mult.py, reference
    # PhenoModel/routing_and_heads_atten.py:81-262)
    fusion_feature_mode: str = "rich"  # concat | rich
    bi_fusion_mode: str = "mlp"  # mlp | attn | linear | mult
    tri_fusion_mode: str = "mlp"
    fusion_dropout: float = 0.1

    # per-route MulT fusion knobs (reference CFG.cross_attn_*;
    # routing_and_heads_atten.py:199-208 build_fusions)
    cross_attn_layers: int = 1
    cross_attn_mask: bool = True  # causal future mask inside each stack

    # sMRO gate (reference: routing.py:21-176). "loss_based" selects the
    # deterministic INSPECT variant (INSPECT/routing.py:10-98): route weights
    # softmax(-alpha * EMA per-route losses), block weights softmax(-alpha *
    # block-mean losses); the EMA lives in TrainState.route_loss_ema
    # (INSPECT/train_fame.py:102,137-140).
    smro_gate_mode: str = "learned"  # learned | loss_based
    smro_alpha: float = 5.0  # INSPECT DEFAULTS["router_alpha"]
    smro_gate_hidden: int = 256
    smro_dropout: float = 0.10
    strict_freeze_gate: bool = False

    # compute
    dtype: str = "bfloat16"  # compute dtype; params & numerics islands stay fp32
    remat: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training loop knobs (reference: env_config.py + flagship main.py)."""

    batch_size: int = 16
    lr: float = 2e-4
    encoder_lr: float = 2e-4
    weight_decay: float = 1e-4
    epochs: int = 50
    grad_clip: float = 0.3
    seed: int = 42

    label_smoothing: float = 0.05
    pos_weight_clip: Tuple[float, float] = (0.1, 5.0)
    sampler_mode: str = "sqrt"  # none | sqrt | pos_weight | hybrid
    # group each batch by note-chunk count (same sampled multiset, tighter
    # chunk-pack capacity per batch); off = reference's pure-random batches
    chunk_bucketing: bool = False
    use_focal: bool = False
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25

    # routing regularizers (reference: MortModel PCA main.py:3092-3126)
    routing_entropy_bonus: float = 0.0
    routing_uniform_penalty: float = 0.0

    # gated-concat auxiliary losses (reference: train_step3 args
    # train_lni_head_aux/aux_lni_weight :407-415). per_route_aux_weight is an
    # extension with NO reference counterpart (step3 supervises only the final
    # head + aux LNI); default 0 = reference behavior.
    aux_lni_weight: float = 0.05
    per_route_aux_weight: float = 0.0

    # CheXpert 14-class auxiliary BCE on the image encoder head (MedFuse
    # parity: MortModel/encoders.py:374-481 aux BCE); 0 = disabled
    chexpert_weight: float = 0.0

    # fairness mixing (reference: Model/train_step3 gamma EDDI mix;
    # train_fame.py soft-EO weight)
    fairness_gamma: float = 0.0
    fairness_kind: str = "eddi"  # eddi | eq_odds

    # robustness features
    route_dropout_p: float = 0.0  # randomly zero one interaction route
    detach_priors_epochs: int = 0  # warmup epochs with detached priors
    encoder_warmup_epochs: int = 2  # enc lr=0 for first N epochs

    # EMA (reference: main.py:58-108)
    ema_decay: float = 0.999
    use_ema: bool = True
    # EMA of per-route losses driving the loss-based sMRO gate
    # (INSPECT/train_fame.py DEFAULTS["ema_beta"]=0.9, update :137-140)
    route_loss_ema_beta: float = 0.9

    # schedule / early stop (reference: main.py:3301-3320)
    plateau_factor: float = 0.5
    plateau_patience: int = 2
    early_stop_patience: int = 5
    min_epochs: int = 20

    # parallelism
    num_data_shards: int = 1
    num_model_shards: int = 1
    # 'model'-axis role: False (default) = sequence parallel (note-chunk axis
    # sharded, weights replicated); True = Megatron tensor parallel on the
    # text-encoder weights (parallel/tp.py) for encoders too big to replicate
    tensor_parallel: bool = False
    # GPipe pipeline parallel: the 'model' axis holds contiguous BERT layer
    # stages; note chunks flow through as microbatches over ICI ppermute hops
    # (parallel/pp.py). Mutually exclusive with tensor_parallel.
    pipeline_parallel: bool = False
    pp_microbatches: int = 0  # microbatches per data shard (0 = stage count)
    # Route-parallel (expert) sharding: the 'model' axis shards the stacked
    # 6-stream MULT cross program on its leading stream axis (parallel/ep.py).
    # Mutually exclusive with tensor_parallel / pipeline_parallel.
    route_parallel: bool = False
    # ZeRO-1: shard Adam moments over 'data' (parallel/zero.py) — redundant
    # replicas of optimizer state are the first thing to spread at scale
    zero_sharded_opt: bool = False
    microbatch: int = 0  # >0 => gradient accumulation over microbatches

    # 3-stage curriculum (reference: Model/train_step{1,2,3}*.py)
    stage: str = ""  # "" | step1 | step2 | step3 | uni | bi | tri

    log_every: int = 50
    max_train_patients: int = 0  # 0 = unlimited (MIMICIV_MAX_TRAIN_PATIENTS)
    ckpt_every: int = 1  # save last.msgpack every N epochs (0 = final only)
    # checkpoint serialization backend:
    #   msgpack      — one portable flax-msgpack file per checkpoint (default)
    #   orbax        — orbax-checkpoint directory; multi-host runs write their
    #                  own shards (no full host gather through one process)
    #   orbax_async  — orbax with background saves: training continues while
    #                  the previous checkpoint is still being written
    ckpt_backend: str = "msgpack"


@dataclass(frozen=True)
class DataConfig:
    data_root: str = ""
    image_root: str = ""  # prefix for relative image paths in images parquet
    split: str = "train"
    # streaming train split (data/streaming.py:StreamingSplit) for cohorts
    # that don't fit host RAM; val/test stay dense. Needs sampler_mode=none.
    stream: bool = False
    stream_shuffle_buffer: int = 4096
    stream_rows_per_read: int = 1024
    # synthetic mini-cohort controls (BASELINE.json.configs[0])
    synthetic: bool = True
    synthetic_n: int = 256
    synthetic_pos_rate: float = 0.25
    synthetic_missing_rate: float = 0.0


@dataclass(frozen=True)
class Config:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    verbose: bool = False
    out_dir: str = "runs"


# ---------------------------------------------------------------------------
# Override machinery
# ---------------------------------------------------------------------------

_SECTIONS = ("encoder", "model", "train", "data")


def _coerce(value: Any, typ: Any) -> Any:
    if typ is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    if typ is tuple:
        # a tuple or a list (JSON, YAML), "(0.1, 5.0)" (a repr, as a JSON
        # config written by an older build holds it) or "0.1,5.0" (--set)
        if isinstance(value, str):
            value = [v for v in value.strip().strip("()[]").split(",") if v.strip()]
        return tuple(float(v) for v in value)
    return value


def _field_types(dc: Any) -> Dict[str, Any]:
    return {f.name: f.type for f in fields(dc)}


def apply_overrides(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    """Apply flat overrides.

    Keys may be dotted ("model.pc_dim") or bare ("pc_dim"); bare keys are
    applied to every section that declares them (mirrors the reference's flat
    MIMICIV_* env map where one name can touch several knobs).
    """
    sections: Dict[str, Dict[str, Any]] = {s: {} for s in _SECTIONS}
    top: Dict[str, Any] = {}
    for key, value in overrides.items():
        if "." in key:
            sec, name = key.split(".", 1)
            if sec not in sections:
                raise KeyError(f"Unknown config section {sec!r}")
            sections[sec][name] = value
        else:
            hit = False
            for sec in _SECTIONS:
                sub = getattr(cfg, sec)
                if key in {f.name for f in fields(sub)}:
                    sections[sec][key] = value
                    hit = True
            if key in {f.name for f in fields(cfg)} and not dataclasses.is_dataclass(
                getattr(cfg, key)
            ):
                top[key] = value
                hit = True
            if not hit:
                raise KeyError(f"Unknown config knob {key!r}")

    new_secs = {}
    for sec in _SECTIONS:
        sub = getattr(cfg, sec)
        if sections[sec]:
            types = _field_types(sub)
            coerced = {k: _coerce(v, _resolve_type(types[k])) for k, v in sections[sec].items()}
            sub = replace(sub, **coerced)
        new_secs[sec] = sub
    if top:
        types = _field_types(cfg)
        top = {k: _coerce(v, _resolve_type(types[k])) for k, v in top.items()}
    return replace(cfg, **new_secs, **top)


def _resolve_type(t: Any) -> Any:
    """A field's annotation (a string under postponed annotations) as the
    type `_coerce` converts to; every Tuple[...] field holds floats."""
    if isinstance(t, str):
        if t.startswith(("Tuple[", "tuple[")):
            return tuple
        return {"int": int, "float": float, "str": str, "bool": bool}.get(t, str)
    return t


ENV_PREFIX = "MIMICIV_"
ENV_JSON_KEY = "MIMICIV_CFG_JSON"

_TRUTHY = ("1", "true", "yes", "on")

# Reference operators' env files use short alias names (reference
# env_config.py:345-511 explicit env map). Aliases whose stripped-lowercase
# name differs from our canonical knob are mapped here so a reference env
# file applies unchanged; names that coincide (MIMICIV_LR, MIMICIV_SEED,
# MIMICIV_ROUTE_PRIOR_FLOOR, ...) already resolve via the generic path.
ENV_ALIASES: Dict[str, str] = {
    "ckpt_root": "out_dir",
    "text_model": "encoder.text_model_name",
    "max_text_len": "encoder.text_max_len",
    "notes_chunk_len": "encoder.text_max_len",  # chunk len == per-chunk max
    "struct_seq_len": "encoder.structured_seq_len",
    "struct_n_feats": "encoder.structured_n_feats",
    "cross_attn_heads": "model.mult_heads",
    "cross_attn_dropout": "model.attn_dropout",
    "route_gate_temp": "model.gate_temp",
    "route_gate_min": "model.gate_min",
    "route_gate_max": "model.gate_max",
    "route_entropy_lambda": "train.routing_entropy_bonus",
    "lambda_route_entropy": "train.routing_entropy_bonus",
    "route_uniform_lambda": "train.routing_uniform_penalty",
    "lambda_route_balance": "train.routing_uniform_penalty",
    "grad_clip_norm": "train.grad_clip",
    "cap_pc_dim": "model.pc_dim",
    "cap_mc_dim": "model.mc_caps_dim",
    "cap_iters": "model.num_routing",
    "cap_act": "model.capsule_act_type",
    "cap_dropout": "model.capsule_dropout",
    "bs": "train.batch_size",
    "bsz": "train.batch_size",
    "debug_samples": "train.max_train_patients",
    "routing_print_every": "train.log_every",
    "routing_warmup_epochs": "train.detach_priors_epochs",
}

# Aliases needing value translation, not just renaming.
ENV_TRANSFORMS: Dict[str, Any] = {
    # MIMICIV_USE_GATES=1 selects the sigmoid-gated capsule path
    "use_gates": lambda v: (
        {"model.capsule_act_type": "sigmoid_gate"}
        if str(v).strip().lower() in _TRUTHY
        else {}
    ),
    # MIMICIV_LOSS=focal|bce -> train.use_focal
    "loss": lambda v: {"train.use_focal": "focal" in str(v).lower()},
    # MIMICIV_TASK uses the reference's long task names
    "task": lambda v: {
        "model.task": {
            "mortality": "mort",
            "in_hospital_mortality": "mort",
            "in-hospital-mortality": "mort",
            "phenotyping": "pheno",
        }.get(str(v).strip().lower(), str(v).strip().lower())
    },
}

# Reference knobs with no TPU-side equivalent: recognized and reported, never
# silently half-applied (VERDICT r2 weak 6).
ENV_INERT: Dict[str, str] = {
    "bert_chunk_bs": "note chunks run as one batched XLA program (no chunk microbatch)",
    "struct_format": "the loader consumes the exporter's parquet schema directly",
    "struct_x_col": "the loader consumes the exporter's parquet schema directly",
    "struct_y_col": "the loader consumes the exporter's parquet schema directly",
    "struct_split_col": "the loader consumes the exporter's parquet schema directly",
    "struct_id_col": "the loader consumes the exporter's parquet schema directly",
    "cross_attn_pool": "fusion pooling is structural (see model.mult_pool for MulT streams)",
    "route_entropy_warm": "regularizer warmups are not implemented (constant lambdas)",
    "route_uniform_warm": "regularizer warmups are not implemented (constant lambdas)",
    "cap_ln": "capsule layer norm is structural in ops/capsule.py",
    "cap_dpose2vote": "vote dimensioning is fixed by pc_dim/mc_caps_dim",
    "precision": "TPU compute is bf16 with fp32 islands; use model.dtype",
    "deterministic": "JAX/XLA execution is deterministic by default",
    "entropy_use_rc": "the entropy regularizer always uses routing coefficients",
    "use_cudnn_benchmark": "no cuDNN on TPU",
    "img_agg": "dead in the reference too — accepted at encoders.py:602, never read in forward",
    "num_workers": "the input pipeline is a prefetched host thread (data/loader.py), not worker processes",
    "prefetch_factor": "the input pipeline is a prefetched host thread (data/loader.py), not worker processes",
    "pin_memory": "no pinned-memory staging on the TPU host path",
    "persistent_workers": "the input pipeline is a prefetched host thread (data/loader.py), not worker processes",
}


def _env_overrides(environ: Mapping[str, str]) -> Tuple[Dict[str, Any], list]:
    """Translate MIMICIV_* env vars -> knob overrides + a list of
    (env_key, reason) pairs that were recognized-but-inert."""
    out: Dict[str, Any] = {}
    inert: list = []
    blob = environ.get(ENV_JSON_KEY)
    if blob:
        out.update(json.loads(blob))
    for key, value in environ.items():
        if key == ENV_JSON_KEY or not key.startswith(ENV_PREFIX):
            continue
        knob = key[len(ENV_PREFIX):].lower()
        if knob in ENV_TRANSFORMS:
            out.update(ENV_TRANSFORMS[knob](value))
        elif knob in ENV_ALIASES:
            out[ENV_ALIASES[knob]] = value
        elif knob in ENV_INERT:
            inert.append((key, ENV_INERT[knob]))
        else:
            out[knob] = value
    return out, inert


def load_cfg(
    path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> Config:
    """Build a Config: defaults <- file (json/yaml) <- env <- overrides.

    Precedence mirrors the reference loader
    (env_config.py:345-511): explicit overrides win over env vars, which win
    over the config file, which wins over dataclass defaults.
    """
    cfg = Config()
    if path:
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            import yaml  # lazy; pyyaml is available in the image

            data = yaml.safe_load(text)
        flat = _flatten(data or {})
        cfg = apply_overrides(cfg, flat)
    env, inert = _env_overrides(environ if environ is not None else os.environ)
    if env:
        known = {k: v for k, v in env.items() if _known(cfg, k)}
        for key in env:
            if key not in known:
                warnings.warn(
                    f"[configs] ignoring unknown env override "
                    f"{ENV_PREFIX}{key.upper()} (no knob named {key!r})",
                    stacklevel=2,
                )
        cfg = apply_overrides(cfg, known)
    for env_key, reason in inert:
        warnings.warn(
            f"[configs] {env_key} is recognized but has no effect here: {reason}",
            stacklevel=2,
        )
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return _validate(cfg)


def _known(cfg: Config, key: str) -> bool:
    """Whether a (possibly dotted) knob name exists anywhere in the tree.

    Unknown MIMICIV_* env vars are reported via warnings and skipped (the
    reference tolerates unrelated env entries); unknown explicit overrides
    still raise.
    """
    name = key.split(".")[-1]
    for sec in _SECTIONS:
        if name in {f.name for f in fields(getattr(cfg, sec))}:
            return True
    return name in {f.name for f in fields(cfg)}


def getattr_nested(cfg: Config, key: str) -> Any:
    if "." in key:
        sec, name = key.split(".", 1)
        return getattr(getattr(cfg, sec), name)
    for sec in _SECTIONS:
        sub = getattr(cfg, sec)
        if key in {f.name for f in fields(sub)}:
            return getattr(sub, key)
    return getattr(cfg, key)


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def _validate(cfg: Config) -> Config:
    """Clamp/validate routing knobs (reference: env_config.py:462-488)."""
    m = cfg.model
    floor = min(max(m.route_prior_floor, 0.0), 1.0)
    ceil = min(max(m.route_prior_ceiling, floor), 1.0)
    temp = max(m.act_temperature, 1e-3)
    if (floor, ceil, temp) != (m.route_prior_floor, m.route_prior_ceiling, m.act_temperature):
        cfg = replace(
            cfg,
            model=replace(
                m, route_prior_floor=floor, route_prior_ceiling=ceil, act_temperature=temp
            ),
        )
    if cfg.model.routes not in ("7", "10"):
        raise ValueError(f"model.routes must be '7' or '10', got {cfg.model.routes!r}")
    if cfg.model.smro_gate_mode not in ("learned", "loss_based"):
        raise ValueError(
            f"model.smro_gate_mode must be 'learned' or 'loss_based', "
            f"got {cfg.model.smro_gate_mode!r}"
        )
    if cfg.encoder.bert_gelu not in ("erf", "tanh", "poly"):
        raise ValueError(
            f"encoder.bert_gelu must be 'erf', 'tanh', or 'poly', "
            f"got {cfg.encoder.bert_gelu!r}"
        )
    if cfg.encoder.bert_ln not in ("fp32", "bf16"):
        raise ValueError(
            f"encoder.bert_ln must be 'fp32' or 'bf16', got {cfg.encoder.bert_ln!r}"
        )
    if cfg.train.ckpt_backend not in ("msgpack", "orbax", "orbax_async"):
        raise ValueError(
            f"train.ckpt_backend must be 'msgpack', 'orbax' or 'orbax_async', "
            f"got {cfg.train.ckpt_backend!r}"
        )
    return cfg


def to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(d: Mapping[str, Any]) -> Config:
    return apply_overrides(Config(), _flatten(dict(d)))
