"""Layers with flax's dtype semantics, and ``pad2d`` (NCHW).

The JAX modules keep f32 parameters and compute in ``dtype``
(``nn.Conv(dtype=bf16, param_dtype=f32)`` casts input, kernel and bias to
bf16; ``nn.BatchNorm(dtype=f32)`` normalizes in f32).  ``Conv2d``, ``Linear``
and ``BatchNorm`` here do the same on PyTorch's layouts, so the parameters
stay f32 and the arithmetic rounds where the reference rounds.  Only
``pad2d`` of ``affganwriting_tpu/models/blocks.py`` is on this slice's path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "zero": "constant"}


def pad2d(x: torch.Tensor, padding: int, pad_type: str) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``padding`` on each side."""
    if padding == 0:
        return x
    return F.pad(x, (padding,) * 4, mode=_PAD_MODES[pad_type])


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, h, w) with channels packed (p, q, c) -> (B, C, 2h, 2w),
    out[:, c, 2i+p, 2j+q] = x[:, (2p+q)*C + c, i, j].  Not
    ``F.pixel_shuffle``, which packs channels as (c, p, q)."""
    b, c4, h, w = x.shape
    c = c4 // 4
    return (x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(b, c, 2 * h, 2 * w))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` on f32 parameters."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


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
    """Inference BatchNorm over dim 1, in f32 whatever the input dtype,
    returning f32 (flax ``nn.BatchNorm(use_running_average=True,
    dtype=f32)``).  Only the running statistics are held: this slice serves
    and does not train."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
