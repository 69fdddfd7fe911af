"""Normalization primitives on NCHW tensors, f32 statistics.

Port of ``affganwriting_tpu/ops/norms.py`` (which works on NHWC): the same
arithmetic, with the spatial axes at (2, 3).
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(n, c) normalization over H, W with biased variance.

    Statistics accumulate in f32 as E[x^2] - E[x]^2; the normalize runs in
    the input dtype: ``(x - mean.to(dt)) * rsqrt(var + eps).to(dt)``."""
    f32 = x.float()
    mean = f32.mean(dim=(2, 3), keepdim=True)
    var = f32.square().mean(dim=(2, 3), keepdim=True) - mean.square()
    scale = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


def adain(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm, scaled by ``std`` and shifted by ``mean`` (both (N, C),
    predicted from the text code)."""
    normed = instance_norm(x, eps)
    return (normed * std[:, :, None, None].to(normed.dtype)
            + mean[:, :, None, None].to(normed.dtype))


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-(n, c) f32 mean and std over H, W with *unbiased* variance.
    Returns two (N, C, 1, 1) tensors."""
    f32 = feat.float()
    n = f32.shape[2] * f32.shape[3]
    mean = f32.mean(dim=(2, 3), keepdim=True)
    var = f32.var(dim=(2, 3), keepdim=True, correction=0)
    if n > 1:
        var = var * (n / (n - 1))
    return mean, torch.sqrt(var + eps)


def mean_variance_norm(feat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(feat - mean) / std with the unbiased std of ``calc_mean_std``."""
    mean, std = calc_mean_std(feat, eps)
    return ((feat.float() - mean) / std).to(feat.dtype)
