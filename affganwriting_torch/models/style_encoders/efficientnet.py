"""EfficientNetV2-L style encoder ("efficientnet_v2_l" registry key), NCHW.

Port of ``affganwriting_tpu/models/style_encoders/efficientnet.py`` (the
reference's ``ImageEncoderEfficientNet``, GAN_word/modules_tro.py:383-458):
torchvision's ``efficientnet_v2_l`` trunk up to feature stage 5 with its
first conv taking the 50-channel style stack, tapped after stages 1..5,
each tap reduced to ``style_dim`` by a 1x1 conv, the last resized to
``final_hw`` (from 4x14 at 64x216).  As in the JAX package, the trunk ends
at stage 5 and has no stochastic depth.

BatchNorm is the port's train-mode ``BatchNorm`` at eps 1e-3 (flax's
momentum 0.9, biased running variance), so ``frozen_stats`` governs it as
it does resnet50's.  SiLU runs on BN's f32 output, then the cast to the
compute dtype.  torchvision weights import through
``utils/torchvision_import.efficientnet_v2_l_state_dict``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import BatchNorm, Conv2d, resize_bilinear
from affganwriting_torch.models.style_encoders import register

# torchvision efficientnet_v2_l features[1..5]: (n_blocks, kind, kernel,
# stride, expand, out_ch, se_ratio)
V2L_STAGES: tuple = (
    (4, "fused", 3, 1, 1, 32, None),
    (7, "fused", 3, 2, 4, 64, None),
    (7, "fused", 3, 2, 4, 96, None),
    (10, "mb", 3, 2, 4, 192, 0.25),
    (19, "mb", 3, 1, 6, 224, 0.25),
)
V2L_STEM = 32


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=1e-3)


class FusedMBConv(nn.Module):
    """kxk expand conv (+BN+SiLU), then 1x1 project (+BN); with expand 1 a
    single kxk conv (+BN+SiLU).  Residual at stride 1 with equal widths."""

    def __init__(self, cin: int, out_ch: int, kernel: int, stride: int,
                 expand: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.residual = stride == 1 and cin == out_ch
        mid, pad = cin * expand, kernel // 2
        if expand != 1:
            self.expand = Conv2d(cin, mid, kernel, stride=stride, padding=pad,
                                 bias=False, compute_dtype=dtype)
            self.expand_bn = _bn(mid)
            self.project = Conv2d(mid, out_ch, 1, bias=False,
                                  compute_dtype=dtype)
        else:
            self.project = Conv2d(cin, out_ch, kernel, stride=stride,
                                  padding=pad, bias=False,
                                  compute_dtype=dtype)
        self.project_bn = _bn(out_ch)

    def forward(self, x):
        dt = self.dtype
        if hasattr(self, "expand"):
            h = F.silu(self.expand_bn(self.expand(x))).to(dt)
            h = self.project_bn(self.project(h)).to(dt)
        else:
            h = F.silu(self.project_bn(self.project(x))).to(dt)
        return h + x if self.residual else h


class MBConv(nn.Module):
    """1x1 expand, kxk depthwise, squeeze-excite, 1x1 project; the
    squeeze width comes from the block's input width, as torchvision's."""

    def __init__(self, cin: int, out_ch: int, kernel: int, stride: int,
                 expand: int, se_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.residual = stride == 1 and cin == out_ch
        mid = cin * expand
        se_ch = max(1, int(cin * se_ratio))
        self.expand = Conv2d(cin, mid, 1, bias=False, compute_dtype=dtype)
        self.expand_bn = _bn(mid)
        self.dw = Conv2d(mid, mid, kernel, stride=stride, padding=kernel // 2,
                         bias=False, groups=mid, compute_dtype=dtype)
        self.dw_bn = _bn(mid)
        self.se_reduce = Conv2d(mid, se_ch, 1, compute_dtype=dtype)
        self.se_expand = Conv2d(se_ch, mid, 1, compute_dtype=dtype)
        self.project = Conv2d(mid, out_ch, 1, bias=False, compute_dtype=dtype)
        self.project_bn = _bn(out_ch)

    def forward(self, x):
        dt = self.dtype
        h = F.silu(self.expand_bn(self.expand(x))).to(dt)
        h = F.silu(self.dw_bn(self.dw(h))).to(dt)
        g = h.mean(dim=(2, 3), keepdim=True)
        g = self.se_expand(F.silu(self.se_reduce(g)))
        h = h * torch.sigmoid(g)
        h = self.project_bn(self.project(h)).to(dt)
        return h + x if self.residual else h


class EfficientNetV2StyleEncoder(nn.Module):
    """Tapped EfficientNetV2 trunk + 1x1 reducers: 5 taps of ``style_dim``
    channels, the last resized to ``final_hw``.  ``stages`` and
    ``stem_ch`` as in ``V2L_STAGES``."""

    def __init__(self, in_channels: int = 50, style_dim: int = 512,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16,
                 stages: Sequence = V2L_STAGES, stem_ch: int = V2L_STEM):
        super().__init__()
        self.final_hw, self.dtype = tuple(final_hw), dtype
        self.stem = Conv2d(in_channels, stem_ch, 3, stride=2, padding=1,
                           bias=False, compute_dtype=dtype)
        self.stem_bn = _bn(stem_ch)
        self.stages: list[list[str]] = []
        cin = stem_ch
        for si, (n, kind, k, s, e, out_ch, se) in enumerate(stages):
            names = []
            for bi in range(n):
                stride = s if bi == 0 else 1
                if kind == "fused":
                    block = FusedMBConv(cin, out_ch, k, stride, e, dtype)
                else:
                    block = MBConv(cin, out_ch, k, stride, e, se, dtype)
                names.append(f"stage{si + 1}_{bi}")
                self.add_module(names[-1], block)
                cin = out_ch
            self.stages.append(names)
            self.add_module(f"reduce{si}", Conv2d(out_ch, style_dim, 1,
                                                  compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.silu(self.stem_bn(self.stem(x))).to(self.dtype)
        results = []
        for si, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            results.append(getattr(self, f"reduce{si}")(h))
        results[-1] = resize_bilinear(results[-1],
                                      self.final_hw).to(self.dtype)
        return results


@register("efficientnet_v2_l")
class EfficientNetV2LStyleEncoder(EfficientNetV2StyleEncoder):
    pass
