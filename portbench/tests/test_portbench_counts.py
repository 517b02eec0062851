"""The frozen counts against hand counts at small shapes."""
import pytest

import tiny  # noqa: F401
from portbench.counts import attention, categories, model_flops, peaks


def test_bound_takes_the_larger_time():
    ms, by = peaks.bound(3.35e9, 1.0, "bf16")  # 1 ms of bytes
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = peaks.bound(1.0, 989e9, "bf16")  # 1 ms of operations
    assert ms == pytest.approx(1.0) and by == "operations"


def test_attention_counts():
    # 2 chunks of T = 4, d = 8 (heads x dh), 4 and 2 valid keys
    assert attention.k1_bytes(2, 4, 8) == 4 * 2 * 4 * 8 * 2 + 2 * 4 * 4
    assert attention.k1_flops([4, 2], 4, 8) == 2 * 2 * 4 * 8 * (4 + 2)  # q.k and p.v, 2 flops a multiply-add
    assert attention.k2_bytes(2, 4, 8, 2) == 8 * 2 * 4 * 8 * 2 + 2 * 4 * 4 + 2 * 2 * 4 * 4
    assert attention.k2_flops([4, 2], 4, 8) == 5 * 2 * 4 * 8 * (4 + 2)


def test_resnet34_convolutions():
    # torchvision's ResNet34 at 224: 3.6 G multiply-adds in its convolutions
    r = model_flops.resnet_flops("resnet34", 224)
    assert r["channels"] == 512 and r["side"] == 7
    assert r["flops"] / 2 == pytest.approx(3.6e9, rel=0.02)


def test_bert_chunk_by_hand():
    cfg = {"encoder": {"d": 4, "text_max_len": 2, "bert_hidden": 3, "bert_intermediate": 5, "bert_layers": 1,
                       "structured_seq_len": 1, "structured_n_feats": 1, "structured_pool": "last",
                       "structured_layers": 0, "vision_backbone": "resnet18", "image_size": 32,
                       "vision_num_classes": 1},
           "model": {"d": 4, "mult_self_layers": 0, "mult_layers": 0, "pc_dim": 1, "mc_caps_dim": 1,
                     "num_classes": 1, "num_routing": 0}}
    parts = model_flops.stay_flops(cfg, [1])
    # q, k, v, o: 4 products of [2, 3] x [3, 3]; FFN [2, 3] x [3, 5] and back; attention 2 x (2 x 1 x 3)
    by_hand = 4 * 2 * 2 * 3 * 3 + 2 * 2 * 2 * 3 * 5 + 2 * 2 * 2 * 1 * 3
    assert parts["note_body"] == by_hand
    assert parts["note_proj"] == 2 * 3 * 4


def test_training_counts_the_frozen_body_once():
    cfg = tiny.shrink()({"config": {"encoder": dict(tiny.TINY["encoder"], finetune_text=False,
                                                    structured_pool="cls", vision_num_classes=14),
                                    "model": dict(tiny.TINY["model"], num_classes=2, num_routing=3)},
                         "traffic": {}})["config"]
    parts = model_flops.stay_flops(cfg, [256, 100])
    total = sum(parts.values())
    assert model_flops.train_flops(cfg, [256, 100]) == pytest.approx(3 * total - 2 * parts["note_body"])
    cfg["encoder"]["finetune_text"] = True
    assert model_flops.train_flops(cfg, [256, 100]) == pytest.approx(3 * total)


def test_categories():
    assert categories.category("void at::vectorized_elementwise_kernel<4, BinaryFunctor>") == "elementwise"
    assert categories.category("attn::attention_fwd_wgmma_kernel<64, 0>") == "attention (K1, K2, K4)"
    assert categories.category("sm90_xmma_gemm_bf16") == "gemm"
