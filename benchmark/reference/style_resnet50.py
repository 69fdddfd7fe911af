"""The reference's ResNet50 style encoder (GAN_word's
ImageEncoderResNet50): bottleneck stages (3, 4, 6, 3), the stem and each
stage's output reduced to ``style_dim`` by a 1x1 convolution, the last
resized to the decoder's size."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import (BatchNorm, Conv, resize_bilinear,
                                        style_args)


class Bottleneck(nn.Module):
    def __init__(self, cin, f, stride, down):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, f, 1, bias=False), BatchNorm(f)
        self.conv2 = Conv(f, f, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(f)
        self.conv3, self.bn3 = Conv(f, 4 * f, 1, bias=False), BatchNorm(4 * f)
        if down:
            self.down_conv = Conv(cin, 4 * f, 1, stride, bias=False)
            self.down_bn = BatchNorm(4 * f)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return torch.relu(h + x)


class ResNet50Encoder(nn.Module):
    def __init__(self, cin=50, style_dim=512, final_hw=(8, 27)):
        super().__init__()
        self.final_hw = tuple(final_hw)
        self.conv1 = Conv(cin, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.stages, taps, c = [], [64], 64
        for li, (n, f) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            names = []
            for bi in range(n):
                stride = 2 if bi == 0 and li > 0 else 1
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck(
                    c, f, stride, bi == 0 and (stride != 1 or c != 4 * f)))
                names.append(name)
                c = 4 * f
            self.stages.append(names)
            taps.append(c)
        for i, tc in enumerate(taps):
            self.add_module(f"reduce{i}", Conv(tc, style_dim, 1))

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        taps = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for names in self.stages:
            for n in names:
                h = getattr(self, n)(h)
            taps.append(h)
        out = [getattr(self, f"reduce{i}")(t) for i, t in enumerate(taps)]
        out[-1] = resize_bilinear(out[-1], self.final_hw)
        return out


def build(cfg: dict) -> nn.Module:
    return ResNet50Encoder(**style_args(cfg))
