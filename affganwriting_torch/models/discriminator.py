"""Patch discriminator D: a pre-activation conv pyramid and a patch head.

Port of ``affganwriting_tpu/models/discriminator.py`` (NCHW).  The pyramid
(16 -> 1024 channels at 6 layers, reflect-padded 3x3 average-pool
downsamples) ends at a 2x7 map for 64x216 words; the head convolves it with
a square kernel of H / 2^(n-1) = 2 at stride W / 2^(n-1) + 1 = 7 into a
(B, 1024) vector of patch logits.  No norms: D has no BatchNorm statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from affganwriting_torch.models.blocks import (
    ActFirstResBlock,
    Conv2dBlock,
    avg_pool_3x3_s2_refpad,
)


class ConvPyramid(nn.Module):
    """The trunk D and the writer classifier share."""

    def __init__(self, n_layers: int = 6, nf0: int = 16, max_nf: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        nf = nf0
        self.stem = Conv2dBlock(1, nf, 7, 1, 3, pad_type="reflect",
                                activation="none", dtype=dtype)
        # (block a, block b, pooled after): n - 1 pooled stages, then one
        # stage at the final size
        self.stages: list[tuple[str, str, bool]] = []
        for i in range(n_layers):
            pooled = i < n_layers - 1
            tag = f"res{i}" if pooled else "res_final_"
            nf_out = min(nf * 2, max_nf)
            self.add_module(tag + "a", ActFirstResBlock(nf, nf, dtype=dtype))
            self.add_module(tag + "b", ActFirstResBlock(nf, nf_out,
                                                        dtype=dtype))
            self.stages.append((tag + "a", tag + "b", pooled))
            nf = nf_out
        self.out_channels = nf

    def forward(self, x):
        h = self.stem(x)
        for a, b, pooled in self.stages:
            h = getattr(self, b)(getattr(self, a)(h))
            if pooled:
                h = avg_pool_3x3_s2_refpad(h)
        return h


def patch_head(n_layers: int, img_height: int, img_width: int, cin: int,
               cout: int, dtype: torch.dtype) -> Conv2dBlock:
    """Act-first LeakyReLU + conv with a square kernel of H / 2^(n-1) at
    stride W / 2^(n-1) + 1 (2 and 7 at 64x216)."""
    ks = img_height // 2 ** (n_layers - 1)
    st = img_width // 2 ** (n_layers - 1) + 1
    return Conv2dBlock(cin, cout, ks, st, activation_first=True,
                       dtype=dtype)


def flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w*C) in the JAX package's (h, w, c) order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class Discriminator(nn.Module):
    """(B, 1, H, W) image -> (B, final_size) patch logits."""

    def __init__(self, img_height: int = 64, img_width: int = 216,
                 final_size: int = 1024, n_layers: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cnn_f = ConvPyramid(n_layers, dtype=dtype)
        self.cnn_c = patch_head(n_layers, img_height, img_width,
                                self.cnn_f.out_channels, final_size, dtype)

    def forward(self, x):
        return flatten_nhwc(self.cnn_c(self.cnn_f(x)))
