"""VGG19-BN 1-D backbone for character-style extraction.

Port of ``affganwriting_tpu/models/line/char_style_vgg.py`` over the
port's ``VGGTrunk``: the 1-channel line repeated to three channels, the
trunk's features averaged over height into a width strip, and a 1x1
adapter to ``out_dim``.
"""

from __future__ import annotations

import torch
from torch import nn

from affganwriting_torch.models.blocks import Conv1d
from affganwriting_torch.models.recognizer.encoder import VGGTrunk


class VGG19Backbone1D(nn.Module):
    """(B, 1, H, W) line image -> (B, W/16, out_dim) strip."""

    def __init__(self, out_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vgg = VGGTrunk(dtype)
        self.adapter = Conv1d(512, out_dim, 1, compute_dtype=dtype)

    def forward(self, x):
        f = self.vgg(x.expand(-1, 3, -1, -1))
        return self.adapter(f.mean(2)).transpose(1, 2)
