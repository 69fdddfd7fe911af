"""Instance norm (+ReLU) of NCHW planes: wrapper of ``csrc/in_relu.cu``.

Replaces the TPU kernel ``affganwriting_tpu/ops/in_relu_pallas.py``
(``instance_norm_relu``; ``pallas_call`` at line 51).

Bound on the card: bytes, one read and one write of x (about five
operations an element).  At the decoder's spatial upsample stages, batch
256 in bf16, that is 226 MB and 453 MB.

Design: in NCHW each (n, c) plane is H*W contiguous elements, so one thread
block owns one plane, holds it in registers, reduces its f32 statistics
and writes it normalized: one read, one write, no C % 128 restriction.
Planes are limited to 16,384 elements, a multiple of 8 (16-byte vectors).

A CUDA tensor goes to the kernel or raises (also when it requires grad
with grad mode on: the kernel is forward-only); a CPU tensor goes to
``in_relu_plain``, which is also the reference the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from affganwriting_torch.ops import cuda_build
from affganwriting_torch.ops.norms import instance_norm

MAX_PLANE = 16384
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def in_relu_plain(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = True) -> torch.Tensor:
    """relu(instance_norm(x)) in plain PyTorch."""
    y = instance_norm(x, eps)
    return torch.relu(y) if relu else y


def in_relu(x: torch.Tensor, eps: float = 1e-5,
            relu: bool = True) -> torch.Tensor:
    """relu(instance_norm(x)) for x (N, C, H, W); the ReLU is optional."""
    if x.device.type == "cpu":
        return in_relu_plain(x, eps, relu)
    cuda_build.require_cuda_tensor(x, "in_relu")
    cuda_build.refuse_autograd("in_relu", x)
    if x.dim() != 4:
        raise ValueError(f"in_relu: expected (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    plane = h * w
    if plane % 8 or plane > MAX_PLANE:
        raise ValueError(f"in_relu: plane H*W = {plane} must be a multiple "
                         f"of 8 and at most {MAX_PLANE}")
    if x.data_ptr() % 16:
        raise ValueError("in_relu: data must be 16-byte aligned")
    y = torch.empty_like(x)
    fn = cuda_build.kernel("affg_in_relu", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), n * c, plane, eps, int(relu),
                 cuda_build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "in_relu")
    cuda_build.count_work(0.0, 2 * x.numel() * x.element_size())
    in_relu.launches += 1
    return y


# host calls that launched the kernel: eager calls and a CUDA graph's
# warm-up and capture, not its replays (``utils/cuda_graphs.py``)
in_relu.launches = 0


def instance_norm_relu(x: torch.Tensor, eps: float = 1e-5,
                       relu: bool = True) -> torch.Tensor:
    """``in_relu`` with the JAX package's signature and layout
    (``ops/in_relu_pallas.py:instance_norm_relu``): x (N, H, W, C) ->
    (N, H, W, C).  The kernel takes NCHW planes, so x is transposed into
    them and the result back."""
    y = in_relu(x.permute(0, 3, 1, 2).contiguous(), eps, relu)
    return y.permute(0, 2, 3, 1)
