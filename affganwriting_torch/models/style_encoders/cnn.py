"""Scratch CNN style encoder ("cnn" registry key), NCHW.

Port of ``affganwriting_tpu/models/style_encoders/cnn.py`` (the reference's
``ImageEncoderStyleCNN``, GAN_word/cnn.py:132-195): a 6-stage instance-
normed, reflect-padded conv pyramid over the 50-channel style stack with an
anisotropic stride-(2, 1) stage; taps of [64, 128, 256, d, d, d] channels,
the last resized to ``final_hw`` (from 5x27 at 64x216).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import Conv2dBlock, resize_bilinear
from affganwriting_torch.models.style_encoders import register


def _pad_w(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad2d((1, 1, 0, 0)): the width only."""
    return F.pad(x, (1, 1, 0, 0), mode="reflect")


@register("cnn")
class CNNStyleEncoder(nn.Module):
    def __init__(self, in_channels: int = 50, style_dim: int = 512,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.final_hw, self.dtype = tuple(final_hw), dtype
        d = style_dim

        def cb(cin, cout, k, s, p):
            return Conv2dBlock(cin, cout, k, s, p, norm="in",
                               activation="relu", pad_type="reflect",
                               dtype=dtype)

        self.enc1 = cb(in_channels, 64, 5, 1, 2)
        self.enc2a = cb(64, 128, 3, 1, 1)
        self.enc2b = cb(128, 128, 3, 1, 1)
        self.enc3a = cb(128, 256, 4, 2, 1)
        self.enc3b = cb(256, 256, 3, 1, 0)
        self.enc4a = cb(256, d, 4, 2, 1)
        self.enc4b = cb(d, d, 3, 1, 0)
        self.enc5 = cb(d, d, (4, 4), (2, 1), 0)
        self.enc6 = cb(d, d, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        r1 = self.enc1(x)
        r2 = self.enc2b(self.enc2a(r1))
        r3 = self.enc3b(_pad_w(self.enc3a(r2)))
        r4 = self.enc4b(_pad_w(self.enc4a(r3)))
        h = self.enc5(_pad_w(r4))
        # (1, 3) windows at stride (1, 2) over a zero-padded width; the
        # zeros count, as in flax's avg_pool
        r5 = F.avg_pool2d(F.pad(h, (1, 1, 0, 0)), (1, 3), (1, 2))
        r6 = resize_bilinear(self.enc6(r5), self.final_hw).to(self.dtype)
        return [r1, r2, r3, r4, r5, r6]
