"""iAFF attentional feature fusion + the fused AdaIN skip path (NCHW).

Port of ``affganwriting_tpu/models/aff.py``.  As there, the second fusion
round reuses ``global_att`` and no ``global_att2`` exists.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import BatchNorm, Conv2d
from affganwriting_torch.ops.norms import adain, mean_variance_norm


class _AttBranch(nn.Module):
    """1x1 conv -> BN -> ReLU -> 1x1 conv -> BN  (channel bottleneck)."""

    def __init__(self, channels: int, inter: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(channels, inter, 1, compute_dtype=dtype)
        self.BatchNorm_0 = BatchNorm(inter)
        self.Conv_1 = Conv2d(inter, channels, 1, compute_dtype=dtype)
        self.BatchNorm_1 = BatchNorm(channels)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)
        return self.BatchNorm_1(self.Conv_1(x)).to(self.dtype)


class IAFF(nn.Module):
    """Iterative attentional feature fusion."""

    def __init__(self, channels: int = 512, r: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inter = channels // r
        self.local_att = _AttBranch(channels, inter, dtype)
        self.global_att = _AttBranch(channels, inter, dtype)
        self.local_att2 = _AttBranch(channels, inter, dtype)

    def forward(self, x, residual):
        def gap(h):
            return h.mean(dim=(2, 3), keepdim=True)

        xa = x + residual
        wei = torch.sigmoid(self.local_att(xa) + self.global_att(gap(xa)))
        xi = x * wei + residual * (1.0 - wei)
        # round 2 reuses global_att, as the reference does
        wei2 = torch.sigmoid(self.local_att2(xi) + self.global_att(gap(xi)))
        return x * wei2 + residual * (1.0 - wei2)


class AdaINFusion(nn.Module):
    """AdaIN with an optional iAFF-fused style skip.

    With ``fuse_skip`` the skip feature is resized to x's grid (nearest with
    half-pixel centres: ``"nearest-exact"``, which is what
    ``jax.image.resize(method="nearest")`` computes; torch's ``"nearest"``
    picks other columns), mean/variance normalized and fused with x by iAFF
    before the adaptive instance norm."""

    def __init__(self, channels: int = 512, dtype: torch.dtype = torch.bfloat16,
                 fuse_skip: bool = False):
        super().__init__()
        if fuse_skip:
            self.iaff = IAFF(channels, dtype=dtype)

    def forward(self, x, mean, std, skip=None):
        if skip is not None:
            key = F.interpolate(skip.float(), size=x.shape[2:],
                                mode="nearest-exact")
            key = mean_variance_norm(key).to(x.dtype)
            x = self.iaff(x, key)
        return adain(x, mean, std)
