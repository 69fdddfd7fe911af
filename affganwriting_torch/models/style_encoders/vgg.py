"""VGG19-IN style encoder ("vgg19" registry key), NCHW: the legacy backbone.

Port of ``affganwriting_tpu/models/style_encoders/vgg.py`` (the reference's
``ImageEncoder`` over its modified ``vgg19_bn``, GAN_word/modules_tro.py:
331-374, vgg_tro_channel3_modi.py:40-90): cfg 'E' without its first max-
pool, instance norm + ReLU after every conv, 50-channel input, tapped into
6 stages of [64, 128, 256, 512, 512, 512] channels.  It has no reducers and
so no ``style_dim``: its width is fixed at 512.  The last tap is resized to
``final_hw`` (8x27 from 8x27 at 64x216).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import Conv2d, resize_bilinear
from affganwriting_torch.models.style_encoders import register
from affganwriting_torch.ops.norms import instance_norm

# (channels, max-pool before) per conv, grouped into the 6 tap stages
_STAGES = (
    ((64, False),),
    ((64, False), (128, False)),
    ((128, False), (256, True)),
    ((256, False), (256, False), (256, False), (512, True)),
    ((512, False), (512, False), (512, False), (512, True)),
    ((512, False), (512, False), (512, False)),
)


@register("vgg19")
class VGG19StyleEncoder(nn.Module):
    def __init__(self, in_channels: int = 50,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.final_hw, self.dtype = tuple(final_hw), dtype
        self.stages: list[list[tuple[str, bool]]] = []
        cin, ci = in_channels, 0
        for stage in _STAGES:
            names = []
            for feats, pool_before in stage:
                self.add_module(f"conv{ci}", Conv2d(
                    cin, feats, 3, padding=1, compute_dtype=dtype))
                names.append((f"conv{ci}", pool_before))
                cin, ci = feats, ci + 1
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for names in self.stages:
            for name, pool_before in names:
                if pool_before:
                    x = F.max_pool2d(x, 2, 2)
                x = torch.relu(instance_norm(getattr(self, name)(x)))
            taps.append(x)
        taps[-1] = resize_bilinear(taps[-1], self.final_hw).to(self.dtype)
        return taps
