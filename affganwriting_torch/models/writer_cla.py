"""Writer classifier C: D's trunk with a ``num_writers``-logit head.

Port of ``affganwriting_tpu/models/writer_cla.py`` (NCHW).
"""

from __future__ import annotations

import torch
from torch import nn

from affganwriting_torch.models.discriminator import (
    ConvPyramid,
    flatten_nhwc,
    patch_head,
)


class WriterClassifier(nn.Module):
    """(B, 1, H, W) image -> (B, num_writers) logits."""

    def __init__(self, num_writers: int = 500, img_height: int = 64,
                 img_width: int = 216, n_layers: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cnn_f = ConvPyramid(n_layers, dtype=dtype)
        self.cnn_c = patch_head(n_layers, img_height, img_width,
                                self.cnn_f.out_channels, num_writers, dtype)

    def forward(self, x):
        return flatten_nhwc(self.cnn_c(self.cnn_f(x)))
