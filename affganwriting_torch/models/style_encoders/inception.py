"""InceptionV3 style encoder ("inception_v3" registry key), NCHW.

Port of ``affganwriting_tpu/models/style_encoders/inception.py`` (the
reference's GAN_word/inception.py:7-130): the InceptionV3 trunk of
``eval/inception_v3.py`` over the 50-channel style stack, tapped at
Mixed_5c / 5d / 6b / 6e / 7c, each tap reduced to ``style_dim`` by a 1x1
conv, the last resized to ``final_hw``.  Below 128 rows the two stride-2
stem convs run at stride 1, and the stem's max-pools pad by 1, so word-
height maps survive.  Mixed_7c average-pools here.

Its BatchNorms are ``RunningBatchNorm``: the running statistics normalize
in G's train mode too and never move, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.eval.inception_v3 import (
    MIXED,
    BasicConv,
    add_mixed_blocks,
)
from affganwriting_torch.models.blocks import Conv2d, resize_bilinear
from affganwriting_torch.models.style_encoders import register

_TAPS = ("Mixed_5c", "Mixed_5d", "Mixed_6b", "Mixed_6e", "Mixed_7c")
_TAP_CHANNELS = (288, 288, 768, 768, 2048)


@register("inception_v3")
class InceptionStyleEncoder(nn.Module):
    def __init__(self, in_channels: int = 50, style_dim: int = 512,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.final_hw, self.dtype = tuple(final_hw), dtype
        self.Conv2d_1a_3x3 = BasicConv(in_channels, 32, 3, padding=1,
                                       dtype=dtype)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, padding=1, dtype=dtype)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1, dtype=dtype)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, dtype=dtype)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, padding=1, dtype=dtype)
        add_mixed_blocks(self, "avg", dtype)
        for i, c in enumerate(_TAP_CHANNELS):
            self.add_module(f"reduce{i}",
                            Conv2d(c, style_dim, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        # stride 2 only from 128 rows up; the stride is the conv's own
        self.Conv2d_1a_3x3.conv.stride = (1, 1) if x.shape[2] < 128 else (2, 2)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h))
        h = F.max_pool2d(h, 3, 2, 1)
        taps = []
        for name in MIXED:
            h = getattr(self, name)(h)
            if name in _TAPS:
                taps.append(h)
        results = [getattr(self, f"reduce{i}")(t) for i, t in enumerate(taps)]
        results[-1] = resize_bilinear(results[-1],
                                      self.final_hw).to(self.dtype)
        return results
