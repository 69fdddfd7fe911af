"""Layers with flax's dtype semantics, and the blocks of the D/C trunk (NCHW).

Port of ``affganwriting_tpu/models/blocks.py``.  The JAX modules keep f32
parameters and compute in ``dtype`` (``nn.Conv(dtype=bf16,
param_dtype=f32)`` casts input, kernel and bias to bf16; ``nn.BatchNorm(
dtype=f32)`` normalizes in f32).  ``Conv2d``, ``Linear`` and ``BatchNorm``
here do the same on PyTorch's layouts, so the parameters stay f32 and the
arithmetic rounds where the reference rounds.  ``BatchNorm`` follows the
module's train/eval mode as flax's ``use_running_average=not train`` does.
``Conv2dBlock``, ``ActFirstResBlock`` and ``avg_pool_3x3_s2_refpad`` build
the discriminator and writer classifier, ``Conv2dBlock`` with instance
norm the ``cnn`` style encoder; ``ResBlock`` and ``LinearBlock`` are not
ported (nothing ported uses them).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.ops.norms import instance_norm

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "zero": "constant"}


def pad2d(x: torch.Tensor, padding: int, pad_type: str) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``padding`` on each side.  A reflect
    pad of a single row or column repeats it, as ``jnp.pad`` does (torch
    refuses it)."""
    if padding == 0:
        return x
    if pad_type == "reflect" and min(x.shape[2:]) == 1:
        for dim, pad in ((2, (0, 0, padding, padding)),
                         (3, (padding, padding, 0, 0))):
            x = F.pad(x, pad, mode="reflect" if x.shape[dim] > 1
                      else "replicate")
        return x
    return F.pad(x, (padding,) * 4, mode=_PAD_MODES[pad_type])


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor to ``size``,
    in f32: half-pixel centres, and a triangle filter widened by the scale
    (antialiasing) along an axis that shrinks, as jax does by default."""
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=shrink)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, h, w) with channels packed (p, q, c) -> (B, C, 2h, 2w),
    out[:, c, 2i+p, 2j+q] = x[:, (2p+q)*C + c, i, j].  Not
    ``F.pixel_shuffle``, which packs channels as (c, p, q)."""
    b, c4, h, w = x.shape
    c = c4 // 4
    return (x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(b, c, 2 * h, 2 * w))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            *, channels: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout(p)`` in train mode: keep each element with
    probability 1 - p and scale it by 1 / (1 - p); with ``channels`` the
    mask is drawn per (n, c) plane of an NCHW tensor (``Dropout2d``, flax's
    ``broadcast_dims`` over H and W).  Masks come from ``generator``; p = 0
    returns x."""
    if p == 0.0:
        return x
    keep_prob = 1.0 - p
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` on f32 parameters;
    ``kernel``, ``stride`` and ``padding`` take an int or an (h, w) pair."""

    def __init__(self, cin: int, cout: int, kernel, *, stride=1, padding=0,
                 bias: bool = True, groups: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, groups=self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` on f32 parameters."""

    def __init__(self, din: int, dout: int, *, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(din, dout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 in f32 whatever the input dtype, returning f32:
    flax ``nn.BatchNorm(use_running_average=not train, momentum=0.9,
    epsilon=1e-5, dtype=f32)``.

    In eval mode it normalizes with the running statistics.  In train mode
    it normalizes with the batch's: mean and flax's fast variance
    ``max(0, E[x^2] - E[x]^2)`` over every axis but dim 1, taken in f32, so
    a (B, C, 1, 1) map at B = 1 gives variance 0 and returns the bias where
    ``F.batch_norm`` would raise.  Unless ``update_stats`` is off (see
    ``frozen_stats``) it then moves the running statistics as flax does,
    ``r <- 0.9 r + 0.1 batch`` with the *biased* variance (torch's own
    update uses the unbiased one)."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = (x.square().mean(dims) - mean.square()).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Train-mode BatchNorms of ``module`` normalize with batch statistics
    but leave their running statistics alone inside the block: flax's
    ``mutable=["batch_stats"]`` with the updates discarded."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield module
    finally:
        for bn, flag in zip(bns, before):
            bn.update_stats = flag


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


_ACTIVATIONS = {"none": None, "lrelu": leaky_relu, "relu": torch.relu}
_NORMS = {"none": None, "in": instance_norm}


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation, or with ``activation_first`` the
    activation before the pad; the flax conv is ``Conv_0``.  ``kernel`` and
    ``stride`` take an int or an (h, w) pair.  Norms: "none" and "in"
    (``ops/norms.instance_norm``); the JAX block's "bn" and "group" wait
    for their line-stack users."""

    def __init__(self, cin: int, cout: int, kernel, stride=1,
                 padding: int = 0, *, norm: str = "none",
                 activation: str = "lrelu", pad_type: str = "zero",
                 bias: bool = True, activation_first: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.padding, self.pad_type = padding, pad_type
        self.norm = _NORMS[norm]
        self.act = _ACTIVATIONS[activation]
        self.activation_first = activation_first
        self.Conv_0 = Conv2d(cin, cout, kernel, stride=stride, bias=bias,
                             compute_dtype=dtype)

    def forward(self, x):
        if self.activation_first and self.act is not None:
            x = self.act(x)
        x = self.Conv_0(pad2d(x, self.padding, self.pad_type))
        if self.norm is not None:
            x = self.norm(x)
        if not self.activation_first and self.act is not None:
            x = self.act(x)
        return x


class ActFirstResBlock(nn.Module):
    """Pre-activation residual block: two LeakyReLU-first reflect-pad 3x3
    ``Conv2dBlock``s to min(fin, fout) and then fout channels, and a
    bias-free 1x1 shortcut only when fin != fout."""

    def __init__(self, fin: int, fout: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        fhid = min(fin, fout)
        self.Conv2dBlock_0 = Conv2dBlock(
            fin, fhid, 3, 1, 1, pad_type="reflect", activation_first=True,
            dtype=dtype)
        self.Conv2dBlock_1 = Conv2dBlock(
            fhid, fout, 3, 1, 1, pad_type="reflect", activation_first=True,
            dtype=dtype)
        if fin != fout:
            self.Conv2dBlock_2 = Conv2dBlock(fin, fout, 1, activation="none",
                                             bias=False, dtype=dtype)

    def forward(self, x):
        dx = self.Conv2dBlock_1(self.Conv2dBlock_0(x))
        if hasattr(self, "Conv2dBlock_2"):
            x = self.Conv2dBlock_2(x)
        return x + dx


def avg_pool_3x3_s2_refpad(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad2d(1) + AvgPool2d(3, stride=2): the D/C downsampler."""
    return F.avg_pool2d(pad2d(x, 1, "reflect"), 3, 2)
