"""Chest X-ray image encoder (counterpart of multimodalrouting_tpu/models/cxr.py).

ResNet-18/34 (BasicBlock) with BatchNorm or GroupNorm(32), a 14-class
CheXpert head, the pooled projection and layer4 spatial tokens. Images enter
NHWC [B,H,W,3] as in the JAX package; the convolutions run on the
channels_last NCHW view of the same memory.

BatchNorm follows flax's: at inference it normalises with the running
statistics; in training with the batch's (float32, E[x^2] - E[x]^2 clipped
at 0, eps 1e-5), and it computes the new running statistics with flax's rule
(momentum 0.9 on the old value, the biased batch variance). Those are not
written into the buffers during the forward: the module keeps them in
``batch_update`` for the train step, which commits them only when the
gradient is finite (``train/state.py:apply_gradients``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models.layers import Dense

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BACKBONES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def normalize_pixels(image: torch.Tensor, has_i: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels -> ImageNet-normalised float32, absent images zeroed.
    Float inputs pass through untouched."""
    if image.dtype != torch.uint8:
        return image
    x = image.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=image.device)
    return (x - mean) / std * has_i.float()[:, None, None, None]


class Conv(nn.Module):
    """Bias-free square conv with symmetric k//2 padding (flax nn.Conv as used here)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        nn.init.kaiming_normal_(self.weight)
        self.stride, self.pad, self.dtype = stride, k // 2, dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), stride=self.stride, padding=self.pad)


class BatchNorm(nn.Module):
    """flax BatchNorm: (x - mean) * (rsqrt(var + eps) * scale) + bias in
    float32, cast to the compute dtype; running statistics at inference,
    batch statistics in training."""

    MOMENTUM = 0.9

    def __init__(self, c: int, dtype, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps, self.dtype = eps, dtype
        self.batch_update = None  # (running_mean, running_var) after the last training forward

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(
                x.float(), self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            ).to(self.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        m = self.MOMENTUM
        with torch.no_grad():
            self.batch_update = (m * self.running_mean + (1 - m) * mean, m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(self.dtype)


class GroupNorm(nn.Module):
    """flax GroupNorm(num_groups=32): float32 statistics per group (fast
    variance), eps 1e-6, float32 affine, cast to the compute dtype."""

    def __init__(self, c: int, dtype, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.groups, self.eps, self.dtype = groups, eps, dtype

    def forward(self, x, train: bool = False):
        b, c, h, w = x.shape
        xf = x.float().reshape(b, self.groups, c // self.groups, h, w)
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return (y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]).to(self.dtype)


def _norm(kind: str, c: int, dtype) -> nn.Module:
    return BatchNorm(c, dtype) if kind == "batch" else GroupNorm(c, dtype)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, stride: int, norm: str, dtype):
        super().__init__()
        self.conv1 = Conv(c_in, filters, 3, stride, dtype)
        self.bn1 = _norm(norm, filters, dtype)
        self.conv2 = Conv(filters, filters, 3, 1, dtype)
        self.bn2 = _norm(norm, filters, dtype)
        if stride != 1 or c_in != filters:
            self.downsample_conv = Conv(c_in, filters, 1, stride, dtype)
            self.downsample_bn = _norm(norm, filters, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-18/34 on NCHW (channels_last) -> (pooled [B,C], fmap [B,C,H4,W4])."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64, norm_kind: str = "batch", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, width, 7, 2, dtype)
        self.bn1 = _norm(norm_kind, width, dtype)
        self.blocks = []
        c_in = width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2**stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(c_in, filters, stride, norm_kind, dtype))
                self.blocks.append(name)
                c_in = filters

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(2, 3)), x


class ImageEncoder(nn.Module):
    """x [B,H,W,3] -> (tokens [B,P,d], token_mask [B,P], pooled [B,d], chexpert [B,classes])."""

    def __init__(self, d: int = 256, vision_backbone: str = "resnet34", vision_num_classes: int = 14,
                 norm_kind: str = "batch", dtype=torch.float32):
        super().__init__()
        if vision_backbone not in BACKBONES:
            raise NotImplementedError(
                f"backbone {vision_backbone!r} is not ported yet (DenseNet: ROADMAP.md, modules still to port)"
            )
        self.backbone = ResNet(BACKBONES[vision_backbone], norm_kind=norm_kind, dtype=dtype)
        c = 64 * 8
        self.chexpert_head = Dense(c, vision_num_classes, dtype=dtype)
        self.proj = Dense(c, d, dtype=dtype)
        self.token_proj = Dense(c, d, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, ...]:
        nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats, fmap = self.backbone(nchw, train)
        chexpert = self.chexpert_head(feats)
        pooled = self.proj(feats)
        b, c, h, w = fmap.shape
        tokens = self.token_proj(fmap.permute(0, 2, 3, 1).reshape(b, h * w, c))
        token_mask = torch.ones((b, h * w), dtype=torch.float32, device=x.device)
        return tokens, token_mask, pooled, chexpert
