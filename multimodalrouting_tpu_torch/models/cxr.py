"""Chest X-ray image encoder (counterpart of multimodalrouting_tpu/models/cxr.py).

ResNet-18/34 (BasicBlock) or DenseNet-121 (MedFuse's default CXR backbone)
with BatchNorm or GroupNorm(32), a 14-class CheXpert head, the pooled
projection and the last feature map's spatial tokens. Images enter NHWC
[B,H,W,3] as in the JAX package; the convolutions run on the channels_last
NCHW view of the same memory. Conv weights are OIHW, as torchvision stores
them, so ``import_torchvision_backbone_params`` maps a torchvision
state_dict onto the backbone by name alone (``block{i}_layer{j}``,
``transition{i}_conv``, ``bn_final``, ``layer{s}_block{b}``), with no
transpose.

BatchNorm follows flax's: at inference it normalises with the running
statistics; in training with the batch's (float32, E[x^2] - E[x]^2 clipped
at 0, eps 1e-5), and it computes the new running statistics with flax's rule
(momentum 0.9 on the old value, the biased batch variance). Those are not
written into the buffers during the forward: the module keeps them in
``batch_update`` for the train step, which commits them only when the
gradient is finite (``train/state.py:apply_gradients``). On a mesh the batch
statistics are the global batch's, so every rank normalises and commits the
same ones, as flax BatchNorm does on the JAX package's globally-sharded
batch: the mean averaged over the data group (``parallel/mesh.global_mean``),
then the variance as the average of each rank's second moment about it
(with one data shard, the one-process statistics). The two passes avoid
flax's E[x^2] - E[x]^2, whose cancellation on a channel with a large mean
and a small spread turns the order of the summation into a visible change
of the variance.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalrouting_tpu_torch.models import init
from multimodalrouting_tpu_torch.models.layers import Dense
from multimodalrouting_tpu_torch.parallel.mesh import get_active_mesh, global_mean

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BACKBONES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3), "densenet121": (6, 12, 24, 16)}


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
        init.param(self, "weight", init.lecun_normal, (k, k, c_in, c_out), (c_out, c_in, k, k))
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
        init.param(self, "weight", init.ones, (c,))
        init.param(self, "bias", init.zeros, (c,))
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
        mean = global_mean(xf.mean(dim=(0, 2, 3)))
        mesh = get_active_mesh()
        if mesh is None or mesh.n_data == 1:  # flax's fast variance, E[x^2] - E[x]^2
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:  # the global batch's centred second moment (equal-size data shards)
            var = global_mean((xf - mean[:, None, None]).square().mean(dim=(0, 2, 3)))
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
        init.param(self, "weight", init.ones, (c,))
        init.param(self, "bias", init.zeros, (c,))
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

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64, norm_kind: str = "batch",
                 dtype=torch.float32, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_channels, width, 7, 2, dtype)
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
        self.out_channels = c_in

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(2, 3)), x


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(bn_size * growth)-BN-ReLU-Conv3x3(growth), concatenated
    onto the input along channels (torchvision's _DenseLayer)."""

    def __init__(self, c_in: int, growth: int, bn_size: int, norm: str, dtype):
        super().__init__()
        self.bn1 = _norm(norm, c_in, dtype)
        self.conv1 = Conv(c_in, bn_size * growth, 1, 1, dtype)
        self.bn2 = _norm(norm, bn_size * growth, dtype)
        self.conv2 = Conv(bn_size * growth, growth, 3, 1, dtype)

    def forward(self, x, train: bool = False):
        y = self.conv1(F.relu(self.bn1(x, train)))
        y = self.conv2(F.relu(self.bn2(y, train)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    """DenseNet-121 on NCHW (channels_last) -> (pooled [B,1024], fmap
    [B,1024,H/32,W/32]): a 7x7/2 stem and 3x3/2 max pool, dense blocks of
    growth 32 and bn_size 4, transitions BN-ReLU-Conv1x1(C/2)-AvgPool 2x2/2
    between them, a final BN-ReLU."""

    def __init__(self, block_sizes: Sequence[int] = (6, 12, 24, 16), growth: int = 32, init_features: int = 64,
                 norm_kind: str = "batch", dtype=torch.float32, in_channels: int = 3, bn_size: int = 4):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv(in_channels, init_features, 7, 2, dtype)
        self.bn0 = _norm(norm_kind, init_features, dtype)
        self.stages = []
        c = init_features
        for stage, n_layers in enumerate(block_sizes, start=1):
            names = []
            for layer in range(n_layers):
                names.append(f"block{stage}_layer{layer}")
                self.add_module(names[-1], DenseLayer(c, growth, bn_size, norm_kind, dtype))
                c += growth
            if stage < len(block_sizes):
                self.add_module(f"transition{stage}_bn", _norm(norm_kind, c, dtype))
                self.add_module(f"transition{stage}_conv", Conv(c, c // 2, 1, 1, dtype))
                c //= 2
            self.stages.append((stage, names))
        self.bn_final = _norm(norm_kind, c, dtype)
        self.n_stages, self.out_channels = len(block_sizes), c

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn0(self.conv0(x.to(self.dtype)), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, names in self.stages:
            for name in names:
                x = getattr(self, name)(x, train)
            if stage < self.n_stages:
                x = F.relu(getattr(self, f"transition{stage}_bn")(x, train))
                x = F.avg_pool2d(getattr(self, f"transition{stage}_conv")(x), 2, stride=2)
        x = F.relu(self.bn_final(x, train))
        return x.mean(dim=(2, 3)), x


def make_backbone(name: str, norm_kind: str = "batch", dtype=torch.float32, in_channels: int = 3) -> nn.Module:
    """The backbone `name` of BACKBONES."""
    if name not in BACKBONES:
        raise ValueError(f"Unsupported backbone {name!r}")
    cls = DenseNet if name.startswith("densenet") else ResNet
    return cls(BACKBONES[name], norm_kind=norm_kind, dtype=dtype, in_channels=in_channels)


def import_torchvision_backbone_params(state_dict, backbone: str) -> dict:
    """A torchvision state_dict (a raw ``model.state_dict()``, BatchNorm
    running statistics included) -> the backbone's state_dict keys
    (norm_kind="batch" layout), as CPU tensors. The classifier (``fc.*`` /
    ``classifier.*``) and BatchNorm's ``num_batches_tracked`` are ignored.
    Conv weights are OIHW on both sides."""
    if backbone not in BACKBONES:
        raise ValueError(f"Unsupported backbone {backbone!r}")
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out: dict = {}

    def put(ours: str, theirs: str, kind: str) -> None:
        if kind == "conv":
            out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
            return
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{ours}.{leaf}"] = sd[f"{theirs}.{leaf}"]

    blocks = BACKBONES[backbone]
    if backbone.startswith("densenet"):
        put("conv0", "features.conv0", "conv")
        put("bn0", "features.norm0", "bn")
        for i, n_layers in enumerate(blocks, start=1):
            for j in range(1, n_layers + 1):
                base = f"features.denseblock{i}.denselayer{j}"
                for ours, theirs, kind in (("bn1", "norm1", "bn"), ("conv1", "conv1", "conv"),
                                           ("bn2", "norm2", "bn"), ("conv2", "conv2", "conv")):
                    put(f"block{i}_layer{j - 1}.{ours}", f"{base}.{theirs}", kind)
            if i < len(blocks):
                put(f"transition{i}_bn", f"features.transition{i}.norm", "bn")
                put(f"transition{i}_conv", f"features.transition{i}.conv", "conv")
        put("bn_final", "features.norm5", "bn")
    else:  # resnet18/34 (BasicBlock)
        put("conv1", "conv1", "conv")
        put("bn1", "bn1", "bn")
        for stage, n_blocks in enumerate(blocks, start=1):
            for b in range(n_blocks):
                base, ours = f"layer{stage}.{b}", f"layer{stage}_block{b}"
                for leaf, kind in (("conv1", "conv"), ("bn1", "bn"), ("conv2", "conv"), ("bn2", "bn")):
                    put(f"{ours}.{leaf}", f"{base}.{leaf}", kind)
                if f"{base}.downsample.0.weight" in sd:
                    put(f"{ours}.downsample_conv", f"{base}.downsample.0", "conv")
                    put(f"{ours}.downsample_bn", f"{base}.downsample.1", "bn")
    return out


class ImageEncoder(nn.Module):
    """x [B,H,W,3] -> (tokens [B,P,d], token_mask [B,P], pooled [B,d], chexpert [B,classes])."""

    def __init__(self, d: int = 256, vision_backbone: str = "resnet34", vision_num_classes: int = 14,
                 norm_kind: str = "batch", dtype=torch.float32):
        super().__init__()
        self.backbone = make_backbone(vision_backbone, norm_kind, dtype)
        c = self.backbone.out_channels
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
