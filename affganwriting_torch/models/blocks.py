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
norm the ``cnn`` style encoder.  ``ResBlock`` and ``LinearBlock`` have no
user in either package (the JAX decoder's residual blocks are AdaIN's, in
``models/decoder.py``): ``tests/test_torch_blocks.py`` holds them, and
``activation_fn``, against the JAX modules.  ``get_group_size``,
``GroupNorm`` and ``Conv1d`` serve the line-generation models.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.ops.norms import instance_norm
from affganwriting_torch.parallel.ops import (
    all_reduce_sum,
    batch_random,
    gather_cat,
    group_size,
    model_input,
)

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
    returns x.  Under ``parallel/ops.batch_shard`` the masks are the
    global batch's rows of this rank."""
    if p == 0.0:
        return x
    keep_prob = 1.0 - p
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    keep = batch_random(torch.rand, shape, generator, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


def with_bias(op, bias: torch.Tensor | None, dt: torch.dtype,
              channel_dim: int = 1) -> torch.Tensor:
    """``op(bias)`` for a product that takes its bias, rounding as flax's
    ``nn.Conv`` and ``nn.Dense`` do: below f32 they round the product to
    ``dt`` and then add the bias rounded to ``dt``, a second rounding.
    A bias fused into the product rounds once, so below f32 the bias is
    added to ``op(None)`` here; in f32 it stays fused."""
    if bias is None or dt == torch.float32:
        return op(None if bias is None else bias.to(dt))
    y = op(None)
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(dt).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` on f32 parameters;
    ``kernel``, ``stride`` and ``padding`` take an int or an (h, w) pair.
    The bias is added as ``with_bias`` says."""

    def __init__(self, cin: int, cout: int, kernel, *, stride=1, padding=0,
                 bias: bool = True, groups: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        return with_bias(lambda b: F.conv2d(x, w, b, self.stride,
                                            self.padding, groups=self.groups),
                         self.bias, dt)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` over (B, C, T) computing in ``compute_dtype`` on f32
    parameters (flax ``nn.Conv`` with a 1-D kernel); the bias as
    ``with_bias`` says."""

    def __init__(self, cin: int, cout: int, kernel: int, *, padding=0,
                 dilation: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, padding=padding,
                         dilation=dilation)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        return with_bias(lambda b: F.conv1d(x, w, b, self.stride,
                                            self.padding, self.dilation),
                         self.bias, dt)


def get_group_size(channels: int) -> int:
    """The JAX package's ``models/blocks.py:get_group_size`` (used there as
    the number of groups): 8, or 4 below 32 channels, when it divides,
    else the prime factor nearest to it (the last such on a tie)."""
    goal = 8 if channels >= 32 else 4
    if channels % goal == 0:
        return goal
    factors, n, f = [], channels, 2
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    best, best_dist = 1, 10 ** 9
    for f in factors:
        if abs(f - goal) <= best_dist:
            best, best_dist = f, abs(f - goal)
    return best


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-6, dtype=f32)`` over dim
    1 of an (N, C, ...) tensor, in f32, returning f32."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` on f32 parameters, the
    bias added as ``with_bias`` says.
    Placed on a mesh's model axis (``parallel/mesh.py``: ``tp`` set, the
    weight and bias holding this rank's block of the output features) it
    gathers the full output over the model group, and sums its input's
    gradient over it."""

    def __init__(self, din: int, dout: int, *, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(din, dout, bias=bias)
        self.compute_dtype = compute_dtype
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            x = model_input(x, self.tp.group)
        x, w = x.to(dt), self.weight.to(dt)
        y = with_bias(lambda b: F.linear(x, w, b), self.bias, dt, -1)
        if self.tp is not None:
            y = gather_cat(y, self.tp.group, self.tp.rank, self.tp.size, -1)
        return y


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
    update uses the unbiased one).

    With ``group`` set (``parallel/mesh.py`` sets the mesh's 'data'
    group) the batch statistics are the global batch's: the sums of x and
    x^2 and the count are summed over the group before the mean and the
    fast variance are formed, as GSPMD's one global program takes them.
    Not ``nn.SyncBatchNorm``, whose Welford statistics and unbiased running
    variance are another result."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = True
        self.group = None
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
        if group_size(self.group) > 1:
            c = x.shape[1]
            sums = all_reduce_sum(torch.cat([
                x.sum(dims), x.square().sum(dims),
                x.new_full((1,), x.numel() // c)]), self.group)
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean.square()).clamp_min(0.0)
        else:
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


# flax's leaky_relu(x, 0.2) is where(x >= 0, x, 0.2 * x) with a weak-typed
# slope: 0.2 rounded to x's dtype (0.2001953125 in bf16)
_LEAK = {dt: torch.tensor(0.2, dtype=dt).item()
         for dt in (torch.float64, torch.float32, torch.bfloat16,
                    torch.float16)}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu(x, 0.2)``, its slope in x's dtype (``_LEAK``)."""
    return F.leaky_relu(x, _LEAK[x.dtype])


_ACTIVATIONS = {"none": None, "lrelu": leaky_relu, "relu": torch.relu,
                "tanh": torch.tanh}


def activation_fn(name: str):
    """The activation called ``name`` ("relu", "lrelu" with slope 0.2,
    "tanh"), or None for "none"; raises on any other name."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation, or with ``activation_first`` the
    activation before the pad; the flax conv is ``Conv_0``.  ``kernel`` and
    ``stride`` take an int or an (h, w) pair.  Norms: "none", "in"
    (``ops/norms.instance_norm``), "bn" (``BatchNorm_0``, f32, following
    the module's train/eval mode) and "group" (``GroupNorm_0`` with
    ``get_group_size(cout)`` groups), the two last cast back to the conv's
    dtype as in the JAX block."""

    def __init__(self, cin: int, cout: int, kernel, stride=1,
                 padding: int = 0, *, norm: str = "none",
                 activation: str = "lrelu", pad_type: str = "zero",
                 bias: bool = True, activation_first: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.padding, self.pad_type = padding, pad_type
        self.act = activation_fn(activation)
        self.activation_first = activation_first
        self.Conv_0 = Conv2d(cin, cout, kernel, stride=stride, bias=bias,
                             compute_dtype=dtype)
        self.norm = norm
        if norm == "bn":
            self.BatchNorm_0 = BatchNorm(cout)
        elif norm == "group":
            self.GroupNorm_0 = GroupNorm(get_group_size(cout), cout)
        elif norm not in ("none", "in"):
            raise ValueError(f"unknown norm {norm!r}")

    def _normed(self, x):
        if self.norm == "in":
            return instance_norm(x)
        if self.norm == "bn":
            return self.BatchNorm_0(x).to(x.dtype)
        if self.norm == "group":
            return self.GroupNorm_0(x).to(x.dtype)
        return x

    def forward(self, x):
        if self.activation_first and self.act is not None:
            x = self.act(x)
        x = self._normed(self.Conv_0(pad2d(x, self.padding, self.pad_type)))
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


class ResBlock(nn.Module):
    """Two 3x3 ``Conv2dBlock``s of ``dim`` channels, padded by
    ``pad_type``, with ``norm``, the first followed by ``activation``, and
    an identity skip: the JAX package's ``ResBlock``."""

    def __init__(self, dim: int, norm: str = "in", activation: str = "relu",
                 pad_type: str = "zero", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(dim, dim, 3, 1, 1, norm=norm,
                                         activation=activation,
                                         pad_type=pad_type, dtype=dtype)
        self.Conv2dBlock_1 = Conv2dBlock(dim, dim, 3, 1, 1, norm=norm,
                                         activation="none",
                                         pad_type=pad_type, dtype=dtype)

    def forward(self, x):
        return x + self.Conv2dBlock_1(self.Conv2dBlock_0(x))


class LinearBlock(nn.Module):
    """Dense (``Dense_0``) -> BatchNorm when ``norm`` is "bn"
    (``BatchNorm_0``, f32, cast back) -> ``activation``: the JAX package's
    ``LinearBlock``, which applies no other norm."""

    def __init__(self, din: int, features: int, norm: str = "none",
                 activation: str = "relu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Dense_0 = Linear(din, features, compute_dtype=dtype)
        if norm == "bn":
            self.BatchNorm_0 = BatchNorm(features)
        self.act = activation_fn(activation)

    def forward(self, x):
        x = self.Dense_0(x)
        if hasattr(self, "BatchNorm_0"):
            x = self.BatchNorm_0(x).to(x.dtype)
        return x if self.act is None else self.act(x)


def avg_pool_3x3_s2_refpad(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad2d(1) + AvgPool2d(3, stride=2): the D/C downsampler."""
    return F.avg_pool2d(pad2d(x, 1, "reflect"), 3, 2)
