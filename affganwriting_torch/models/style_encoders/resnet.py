"""ResNet style encoders over the 50-image style stack (NCHW).

Port of ``affganwriting_tpu/models/style_encoders/resnet.py``: a
torchvision-layout ResNet whose first conv takes the style stack, tapped at
{stem-relu, layer1..layer4}, each tap reduced to ``style_dim`` channels by a
1x1 conv, and the last tap resized bilinearly (``blocks.resize_bilinear``,
as ``jax.image.resize``) to ``final_hw``.  Submodule names follow the flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import BatchNorm, Conv2d, resize_bilinear
from affganwriting_torch.models.style_encoders import register


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False,
                            compute_dtype=dtype)
        self.bn3 = BatchNorm(features * 4)
        if downsample:
            self.down_conv = Conv2d(cin, features * 4, 1, stride=stride,
                                    bias=False, compute_dtype=dtype)
            self.down_bn = BatchNorm(features * 4)

    def forward(self, x):
        dt = self.conv1.compute_dtype
        h = torch.relu(self.bn1(self.conv1(x)).to(dt))
        h = torch.relu(self.bn2(self.conv2(h)).to(dt))
        h = self.bn3(self.conv3(h)).to(dt)
        identity = x
        if hasattr(self, "down_conv"):
            identity = self.down_bn(self.down_conv(x)).to(dt)
        return torch.relu(h + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn2 = BatchNorm(features)
        if downsample:
            self.down_conv = Conv2d(cin, features, 1, stride=stride,
                                    bias=False, compute_dtype=dtype)
            self.down_bn = BatchNorm(features)

    def forward(self, x):
        dt = self.conv1.compute_dtype
        h = torch.relu(self.bn1(self.conv1(x)).to(dt))
        h = self.bn2(self.conv2(h)).to(dt)
        identity = x
        if hasattr(self, "down_conv"):
            identity = self.down_bn(self.down_conv(x)).to(dt)
        return torch.relu(h + identity)


class _ResNetStyleEncoder(nn.Module):
    """Tapped ResNet trunk + 1x1 reducers to ``style_dim`` per tap."""

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 in_channels: int = 50, style_dim: int = 512,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.final_hw = tuple(final_hw)
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3,
                            bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.stages: list[list[str]] = []
        tap_channels = [64]
        cin = 64
        for li, (n_blocks, width) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                out = width * block.expansion
                down = bi == 0 and (stride != 1 or cin != out)
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, block(cin, width, stride, down, dtype))
                names.append(name)
                cin = out
            self.stages.append(names)
            tap_channels.append(cin)
        for i, c in enumerate(tap_channels):
            self.add_module(f"reduce{i}",
                            Conv2d(c, style_dim, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = torch.relu(self.bn1(self.conv1(x))).to(self.dtype)
        taps = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        results = [getattr(self, f"reduce{i}")(t) for i, t in enumerate(taps)]
        results[-1] = resize_bilinear(results[-1],
                                      self.final_hw).to(self.dtype)
        return results


@register("resnet50")
class ResNet50StyleEncoder(_ResNetStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__((3, 4, 6, 3), Bottleneck, **kwargs)


@register("resnet18")
class ResNet18StyleEncoder(_ResNetStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__((2, 2, 2, 2), BasicBlock, **kwargs)
