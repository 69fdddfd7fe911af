"""InceptionV3 pool3 feature extractor for FID, NCHW.

The port of ``affganwriting_tpu/eval/inception_v3.py``: torchvision's /
pytorch-fid's InceptionV3 (the reference's GAN_word/fid_folder/
inception.py) up to the global average pool, 2048-d "pool3" activations.
Parameter names are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
``Conv2d_1a_3x3.bn.running_var``), so a torchvision or pytorch-fid state
dict loads with ``load_state_dict`` once ``AuxLogits.*``, ``fc.*`` and
``num_batches_tracked`` are dropped.  pytorch-fid's TF-compatible details
are kept: the average-pool branches exclude padding from the count, and the
second InceptionE block (Mixed_7c) max-pools.

Every BatchNorm normalizes with its running statistics (eps 1e-3), in
training too: ``RunningBatchNorm``, which ``models/blocks.frozen_stats``
does not touch.  The ``inception_v3`` style encoder reuses these blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import Conv2d, resize_bilinear


def avg_pool_3x3_same_nocount(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool; padded cells are not counted."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class RunningBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, dtype=f32)``: always
    the running statistics, never updated, in f32 whatever the input dtype;
    the scale and bias still train."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicConv(nn.Module):
    """conv (no bias) -> ``RunningBatchNorm`` -> ReLU, cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False, compute_dtype=dtype)
        self.bn = RunningBatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x))).to(self.dtype)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1, dtype=dtype)
        self.branch5x5_1 = BasicConv(cin, 48, 1, dtype=dtype)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2, dtype=dtype)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, dtype=dtype)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1, dtype=dtype)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1, dtype=dtype)
        self.branch_pool = BasicConv(cin, pool_features, 1, dtype=dtype)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_same_nocount(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, dtype=dtype)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, dtype=dtype)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1, dtype=dtype)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, dtype=dtype)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = BasicConv(cin, 192, 1, dtype=dtype)
        self.branch7x7_1 = BasicConv(cin, c7, 1, dtype=dtype)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=p17, dtype=dtype)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=p71,
                                     dtype=dtype)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1, dtype=dtype)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=p71,
                                        dtype=dtype)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=p17,
                                        dtype=dtype)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=p71,
                                        dtype=dtype)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=p17,
                                        dtype=dtype)
        self.branch_pool = BasicConv(cin, 192, 1, dtype=dtype)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_same_nocount(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1, dtype=dtype)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2, dtype=dtype)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1, dtype=dtype)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3),
                                       dtype=dtype)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0),
                                       dtype=dtype)
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2, dtype=dtype)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` "avg" (Mixed_7b) or "max" (Mixed_7c of pytorch-fid)."""

    def __init__(self, cin: int, pool_mode: str = "avg",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv(cin, 320, 1, dtype=dtype)
        self.branch3x3_1 = BasicConv(cin, 384, 1, dtype=dtype)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1),
                                      dtype=dtype)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0),
                                      dtype=dtype)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1, dtype=dtype)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1, dtype=dtype)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1),
                                         dtype=dtype)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0),
                                         dtype=dtype)
        self.branch_pool = BasicConv(cin, 192, 1, dtype=dtype)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = avg_pool_3x3_same_nocount(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


def add_mixed_blocks(module: nn.Module, last_pool: str,
                     dtype: torch.dtype) -> None:
    """Mixed_5b .. Mixed_7c on ``module``, taking the 192 channels of the
    stem; Mixed_7c pools with ``last_pool``."""
    blocks = [("Mixed_5b", InceptionA(192, 32, dtype)),
              ("Mixed_5c", InceptionA(256, 64, dtype)),
              ("Mixed_5d", InceptionA(288, 64, dtype)),
              ("Mixed_6a", InceptionB(288, dtype)),
              ("Mixed_6b", InceptionC(768, 128, dtype)),
              ("Mixed_6c", InceptionC(768, 160, dtype)),
              ("Mixed_6d", InceptionC(768, 160, dtype)),
              ("Mixed_6e", InceptionC(768, 192, dtype)),
              ("Mixed_7a", InceptionD(768, dtype)),
              ("Mixed_7b", InceptionE(1280, "avg", dtype)),
              ("Mixed_7c", InceptionE(2048, last_pool, dtype))]
    for name, block in blocks:
        module.add_module(name, block)


MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
         "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
         "Mixed_7c")


class InceptionV3Pool3(nn.Module):
    """(B, 3, H, W) in [0, 1] -> (B, 2048) f32 pool3 activations.

    ``resize_input`` and ``normalize_input`` are pytorch-fid's wrapper
    defaults: a bilinear resize to 299x299 in f32 (``jax.image.resize``'s;
    an upsample for FID's 64x64 crops), then x -> 2x - 1."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, dtype=dtype)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, dtype=dtype)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1, dtype=dtype)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, dtype=dtype)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, dtype=dtype)
        add_mixed_blocks(self, "max", dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        if self.normalize_input:
            x = x * 2.0 - 1.0
        x = x.to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in MIXED:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))
