"""The reference's DINOv2 ViT-L/14 style encoder (facebook/dinov2-large's
widths): hidden 1024, 24 blocks, 16 heads, tapped after blocks 4, 8, 16
and 23."""

from __future__ import annotations

from torch import nn

from benchmark.reference.models import ViTEncoder, style_args


def build(cfg: dict) -> nn.Module:
    return ViTEncoder(1024, 24, 16, (4, 8, 16, 23), **style_args(cfg))
