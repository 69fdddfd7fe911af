"""Spaced line generator (StyleGAN-flavoured), NCHW.

Port of ``affganwriting_tpu/models/line/spaced_gen.py``: a spaced one-hot
content map (B, n_class[+styles], 1, L) grows through five
``StyledConvBlock``s (a (4, 3) transposed conv, two vertical-only nearest
x2 upsamples, two fused x2 transposed-conv upsamples, each followed by a
3x3 binomial blur) into a (B, 1, 64, 4L) tanh image; each block is conv ->
noise injection -> leaky ReLU -> AdaIN(style), twice.  The style passes
PixelNorm and six dense layers first.

Equalized learning rate: ``EqualConv``, ``FusedUpsample`` and
``NoiseInjection`` keep their parameters at N(0, 1) (0.01 for the noise
weights) and multiply them by sqrt(2 / fan_in) when used.  The flax
kernels' (kh, kw, I, O) layout becomes (O, I, kh, kw) (``utils/from_flax``);
the transposed convs are ``F.conv_transpose2d`` with the unflipped kernel,
which is the JAX package's flipped, input-dilated conv.

Noise: each block draws two (B, C, H, W) normal tensors from the
``torch.Generator`` passed in (the JAX package's ``"noise"`` rng), or
takes the ten tensors the caller hands in, block by block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import Conv2d
from affganwriting_torch.parallel.ops import batch_random

_BLUR = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]) / 16.0


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-8)


def blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 binomial blur, zero padding 1."""
    c = x.shape[1]
    w = _BLUR.to(x)[None, None].expand(c, 1, 3, 3)
    return F.conv2d(x, w, padding=1, groups=c)


class EqualConv(nn.Module):
    """Conv whose N(0, 1) weight is scaled by sqrt(2 / fan_in) when used."""

    def __init__(self, cin: int, features: int, kernel=(1, 1), padding=0):
        super().__init__()
        self.padding = padding
        self.scale = math.sqrt(2.0 / (cin * kernel[0] * kernel[1]))
        self.weight = nn.Parameter(torch.randn(features, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        padding=self.padding)


class NoiseInjection(nn.Module):
    """x + weight * sqrt(2 / C) * noise, per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = math.sqrt(2.0 / channels)
        self.weight = nn.Parameter(torch.full((channels,), 0.01))

    def forward(self, x, noise):
        w = (self.weight * self.scale).to(x.dtype)
        return x + w.view(1, -1, 1, 1) * noise.to(x.dtype)


class StyleAdaIN(nn.Module):
    """Instance norm (f32, biased variance, eps 1e-5) and a per-style
    affine from ``style`` (Linear(style_dim -> 2C), bias gamma 1, beta 0)."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.style = nn.Linear(style_dim, 2 * channels)
        with torch.no_grad():
            self.style.bias.copy_(torch.cat([torch.ones(channels),
                                             torch.zeros(channels)]))

    def forward(self, x, style):
        c = x.shape[1]
        affine = self.style(style.float())
        gamma, beta = affine[:, :c, None, None], affine[:, c:, None, None]
        x32 = x.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = x32.var(dim=(2, 3), keepdim=True, correction=0)
        normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return (gamma * normed + beta).to(x.dtype)


class FusedUpsample(nn.Module):
    """Transposed conv x2 (or x2 in height only) whose (k+1)-kernel is the
    average of the four shifts of an equal-lr'd k-kernel."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 padding: int = 1, only_vertical: bool = False):
        super().__init__()
        self.padding = padding
        self.stride = (2, 1) if only_vertical else (2, 2)
        self.mult = math.sqrt(2.0 / (cin * kernel * kernel))
        self.weight = nn.Parameter(torch.randn(features, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        wp = F.pad(self.weight * self.mult, (1, 1, 1, 1))
        wk = (wp[..., 1:, 1:] + wp[..., :-1, 1:] + wp[..., 1:, :-1]
              + wp[..., :-1, :-1]) / 4.0
        return F.conv_transpose2d(x, wk.transpose(0, 1), self.bias,
                                  stride=self.stride, padding=self.padding)


class InitialConv(nn.Module):
    """ConvTranspose2d((4, 3), padding (0, 1)): (B, C, 1, L) -> (B, F, 4,
    L).  ``weight`` is the flax kernel in the conv layout (F, C, 4, 3)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, 4, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(cin * 12))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.transpose(0, 1), self.bias,
                                  padding=(0, 1))


class StyledConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, style_dim: int = 128, *,
                 initial: bool = False, upsample: bool = False,
                 only_vertical: bool = False, fused: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.initial, self.upsample, self.fused = initial, upsample, fused
        self.scale = (2, 1) if only_vertical else (2, 2)
        if initial:
            self.conv1 = InitialConv(cin, features)
        elif upsample and fused:
            self.conv1 = FusedUpsample(cin, features, 3, 1, only_vertical)
        else:
            self.conv1 = Conv2d(cin, features, 3, padding=1,
                                compute_dtype=dtype)
        self.noise1 = NoiseInjection(features)
        self.adain1 = StyleAdaIN(features, style_dim)
        self.conv2 = Conv2d(features, features, 3, padding=1,
                            compute_dtype=dtype)
        self.noise2 = NoiseInjection(features)
        self.adain2 = StyleAdaIN(features, style_dim)

    def forward(self, x, style, noise=None,
                generator: torch.Generator | None = None):
        """``noise``: the block's two noise tensors, else drawn from
        ``generator`` as each is needed."""
        if self.upsample and not self.fused:
            x = F.interpolate(x, scale_factor=self.scale, mode="nearest")
        out = self.conv1(x)
        if self.upsample:
            out = blur3x3(out)

        def draw(i, like):
            if noise is not None:
                return noise[i]
            return batch_random(torch.randn, like.shape, generator,
                                like.device)

        out = F.leaky_relu(self.noise1(out, draw(0, out)), 0.2)
        out = self.adain1(out, style)
        out = self.conv2(out)
        out = F.leaky_relu(self.noise2(out, draw(1, out)), 0.2)
        return self.adain2(out, style)


class SpacedGenerator(nn.Module):
    """spaced (B, L, n_class) one-hot, style (B, style_size), with
    ``char_style_dim > 0`` per-position styles (B, L, char_style_dim) ->
    (B, 1, 64, 4L) in [-1, 1]."""

    def __init__(self, n_class: int = 80, style_size: int = 128,
                 dim: int = 256, output_dim: int = 1, n_style_trans: int = 6,
                 append_style: bool = True, char_style_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_style_trans, self.append_style = n_style_trans, append_style
        self.char_style_dim = char_style_dim
        for i in range(n_style_trans):
            self.add_module(f"style_emb{i}", nn.Linear(style_size,
                                                       style_size))
        cin = n_class + char_style_dim + (style_size if append_style else 0)
        d = dim
        specs = ((d, dict(initial=True)),
                 (d // 2, dict(upsample=True, only_vertical=True)),
                 (d // 4, dict(upsample=True, only_vertical=True)),
                 (d // 8, dict(upsample=True, fused=True)),
                 (d // 16, dict(upsample=True, fused=True)))
        for i, (feats, kw) in enumerate(specs):
            self.add_module(f"block{i}", StyledConvBlock(
                cin, feats, style_size, dtype=dtype, **kw))
            cin = feats
        self.out = EqualConv(cin, output_dim)

    def forward(self, spaced, style, pos_style=None, *,
                generator: torch.Generator | None = None, noise=None):
        """``noise``: ten tensors, two a block in order; else drawn from
        ``generator``."""
        b, length, _ = spaced.shape
        s = pixel_norm(style)
        for i in range(self.n_style_trans):
            s = F.leaky_relu(getattr(self, f"style_emb{i}")(s), 0.2)
        parts = [spaced]
        if self.char_style_dim > 0:
            parts.append(pos_style.to(spaced.dtype))
        if self.append_style:
            parts.append(s[:, None, :].expand(b, length, s.shape[-1])
                         .to(spaced.dtype))
        x = torch.cat(parts, -1).transpose(1, 2)[:, :, None, :]
        for i in range(5):
            x = getattr(self, f"block{i}")(
                x, s, None if noise is None else noise[2 * i:2 * i + 2],
                generator)
        return torch.tanh(self.out(x))
