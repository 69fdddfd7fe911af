"""Folded 7x7 conv + tanh head in phase layout: wrapper of
``csrc/phase_head.cu``.

Replaces the TPU kernel ``affganwriting_tpu/ops/phase_head_pallas.py``
(``phase_head_fold``; ``pallas_call`` at line 72).

Bound on the card: bytes.  It reads the reflect-padded phase tensor once
(about 2.06 MB an image in bf16 at the default config) and writes a
(2h, 2w) image; its 2*4C*100 operations per low-res pixel sit below the
card's operations-per-byte balance.

Design: one thread block per (image, 16x16 low-res tile) stages the tile
plus a 4-pixel halo and the folded kernel in shared memory chunk by chunk
of channels, accumulates the 4 phase sums per pixel in f32, and writes
tanh(sum + bias) straight to the (2h, 2w) image: the depth-to-space that
runs outside the Pallas kernel is fused here.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
``phase_head_plain``, which is also the reference the kernel is held
against.
"""

from __future__ import annotations

import ctypes

import torch

from affganwriting_torch.models.blocks import depth_to_space
from affganwriting_torch.ops import cuda_build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def phase_head_plain(xp: torch.Tensor, kc: torch.Tensor,
                     bias4: torch.Tensor) -> torch.Tensor:
    """The head in plain PyTorch, in f32: one product to tap-major z
    (B, 100, h+4, w+4), the 25 shifted tap adds, bias, tanh, then the
    depth-to-space.  Returns (B, 1, 2h, 2w) in xp's dtype."""
    b, _, hp, wp = xp.shape
    h, w = hp - 4, wp - 4
    z = torch.einsum("bchw,ck->bkhw", xp.float(), kc.float())
    acc = torch.zeros(b, 4, h, w, dtype=torch.float32, device=xp.device)
    for t in range(25):
        dy, dx = divmod(t, 5)
        acc = acc + z[:, 4 * t:4 * t + 4, dy:dy + h, dx:dx + w]
    y = torch.tanh(acc + bias4.float().view(1, 4, 1, 1))
    return depth_to_space(y).to(xp.dtype)


def phase_head(xp: torch.Tensor, kc: torch.Tensor,
               bias4: torch.Tensor) -> torch.Tensor:
    """xp (B, 4C, h+4, w+4), kc (4C, 100), bias4 (4,) -> (B, 1, 2h, 2w)."""
    if xp.device.type == "cpu":
        return phase_head_plain(xp, kc, bias4)
    cuda_build.require_cuda_tensor(xp, "phase_head xp")
    cuda_build.require_cuda_tensor(kc, "phase_head kc")
    if xp.dim() != 4 or xp.shape[2] <= 4 or xp.shape[3] <= 4:
        raise ValueError(f"phase_head: bad xp shape {tuple(xp.shape)}")
    b, c4, hp, wp = xp.shape
    if kc.shape != (c4, 100) or kc.dtype != xp.dtype \
            or kc.device != xp.device:
        raise ValueError(f"phase_head: kc must be ({c4}, 100) {xp.dtype} on "
                         f"{xp.device}, got {tuple(kc.shape)} {kc.dtype} on "
                         f"{kc.device}")
    if bias4.numel() != 4:
        raise ValueError(f"phase_head: bias4 must have 4 values, got "
                         f"{bias4.numel()}")
    if b > 65535:
        raise ValueError(f"phase_head: batch {b} above the grid's 65,535")
    bias = bias4.detach().to(device=xp.device, dtype=torch.float32) \
        .contiguous()
    h, w = hp - 4, wp - 4
    out = torch.empty(b, 1, 2 * h, 2 * w, dtype=xp.dtype, device=xp.device)
    fn = cuda_build.kernel("affg_phase_head", _ARGTYPES)
    with torch.cuda.device(xp.device):
        err = fn(xp.data_ptr(), kc.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, c4, h, w,
                 cuda_build.DTYPE_CODES[xp.dtype],
                 torch.cuda.current_stream(xp.device).cuda_stream)
    cuda_build.check(err, "phase_head")
    phase_head.launches += 1
    return out


phase_head.launches = 0
