"""Folded 7x7 conv + tanh head in phase layout: wrapper of
``csrc/phase_head.cu``.

Replaces the TPU kernel ``affganwriting_tpu/ops/phase_head_pallas.py``
(``phase_head_fold``; ``pallas_call`` at line 72).

Bound on the card: bytes.  The head is one product (pixels x 4C) . (4C x
100) to tap-major z, then a 25-tap fold; at about 100 operations a byte it
sits under the H100's ~295 bf16 operations a byte, so the least time is the
one read of the reflect-padded phase tensor: 0.16 ms at batch 256 (about
2.06 MB an image in bf16 at the default config).

Two routes, chosen by dtype (no fallback from one to the other):

* bf16 -> ``affg_phase_head_wgmma``, counted in ``phase_head.launches_wgmma``.
  A CUDA-core design cannot reach the bound: the product's 45.3 GFLOP at
  batch 256 take 0.68 ms at the card's f32 FMA rate.  So the product runs on
  ``wgmma`` (bf16 in, f32 accumulate), row of xp by row of xp, fed by TMA
  through an ``mbarrier`` ring; z stays f32 in shared memory, and the fold,
  bias, tanh and depth-to-space are fused after it.  One CTA walks the
  R + 4 padded rows of one (image, strip of R output rows); ``strip_rows``
  picks R.  kc is packed once per call by ``pack_kc`` into the swizzled
  K-major layout ``wgmma`` reads.  Shapes: ``wgmma_shape_error``.
* f32 -> ``affg_phase_head_f32``, the CUDA-core kernel, counted in
  ``phase_head.launches``: the exact-f32 reference runs, which TF32 tensor
  cores would not hold to 1e-4.

Both kernels are forward-only: a CUDA input that requires grad with grad
mode on raises.  A CPU tensor goes to ``phase_head_plain``, which is also
the reference both kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from affganwriting_torch.models.blocks import depth_to_space
from affganwriting_torch.ops import cuda_build

# tiles of the bf16 kernel (csrc/phase_head.cu)
KCHUNK = 64      # channels per K-chunk: one 128-byte swizzle row
NPAD = 104       # 100 tap-phase columns padded to wgmma's multiple of 8
ROW_TILE = 128   # pixels of one padded row's product
MAX_C4 = 256     # kc stays resident in shared memory

_ARGS_WGMMA = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGS_F32 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def _plane_error(shape) -> str | None:
    """What both kernels ask of xp's (B, 4C, h+4, w+4) shape."""
    if len(shape) != 4:
        return f"xp must be (B, 4C, h+4, w+4), got {tuple(shape)}"
    b, _, hp, wp = shape
    if not 1 <= b <= 65535:
        return f"batch {b} outside the grid's 1..65,535"
    if hp <= 4 or wp <= 4:
        return f"padded plane {hp} x {wp} holds no output pixel"
    return None


def wgmma_shape_error(shape, dtype: torch.dtype) -> str | None:
    """Why the bf16 kernel cannot take xp of this (B, 4C, h+4, w+4) shape
    and dtype, or None when it can."""
    if dtype != torch.bfloat16:
        return f"dtype {dtype}, not bfloat16"
    why = _plane_error(shape)
    if why is not None:
        return why
    _, c4, _, wp = shape
    if c4 % KCHUNK or not 0 < c4 <= MAX_C4:
        return f"4C = {c4} must be a multiple of {KCHUNK} up to {MAX_C4}"
    if wp % 8:
        return (f"w+4 = {wp} must be a multiple of 8: each padded row starts "
                "a TMA box, at a 16-byte aligned offset")
    if wp > ROW_TILE:
        return f"w+4 = {wp} above the {ROW_TILE}-pixel row tile"
    return None


def strip_rows(batch: int, h: int, sms: int) -> int:
    """Strip height R of the bf16 kernel: the R that minimises (waves of
    CTAs over ``sms`` SMs, one CTA an SM) x (R + 4 padded rows a CTA);
    ties go to the larger R, which reads fewer halo rows twice.  R = h
    (xp read once) whenever batch alone fills the card."""
    best, best_cost = h, None
    for r in range(h, 0, -1):
        ctas = batch * math.ceil(h / r)
        cost = math.ceil(ctas / sms) * (r + 4)
        if best_cost is None or cost < best_cost:
            best, best_cost = r, cost
    return best


def pack_kc(kc: torch.Tensor) -> torch.Tensor:
    """kc (4C, 100) -> (4C/64, 104, 64): per 64-channel K-chunk, the
    zero-padded 104 columns as rows of 64 channels (K-major), each row's
    eight 16-byte groups swizzled to group ^ (row % 8), as wgmma's 128-byte
    swizzle reads them.  Two launches: the pad and one gather."""
    c4 = kc.shape[0]
    padded = torch.nn.functional.pad(kc, (0, NPAD - kc.shape[1]))
    return padded.view(-1).take(_pack_index(c4, kc.device)) \
        .view(c4 // KCHUNK, NPAD, KCHUNK)


@functools.cache
def _pack_index(c4: int, device: torch.device) -> torch.Tensor:
    """For each element (k, n, s) of the packed kc, its flat index in the
    (4C, 104) zero-padded kc: channel k*64 + 8*((s // 8) ^ (n % 8)) + s % 8,
    column n."""
    k = torch.arange(c4 // KCHUNK).view(-1, 1, 1)
    n = torch.arange(NPAD).view(1, -1, 1)
    s = torch.arange(KCHUNK).view(1, 1, -1)
    chan = k * KCHUNK + 8 * ((s // 8) ^ (n % 8)) + s % 8
    return (chan * NPAD + n).reshape(-1).to(device)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _operand_error(xp: torch.Tensor, kc: torch.Tensor,
                   bias4: torch.Tensor) -> str | None:
    c4 = xp.shape[1]
    if kc.shape != (c4, 100) or kc.dtype != xp.dtype \
            or kc.device != xp.device:
        return (f"kc must be ({c4}, 100) {xp.dtype} on {xp.device}, got "
                f"{tuple(kc.shape)} {kc.dtype} on {kc.device}")
    if bias4.numel() != 4:
        return f"bias4 must have 4 values, got {bias4.numel()}"
    return None


def phase_head(xp: torch.Tensor, kc: torch.Tensor,
               bias4: torch.Tensor) -> torch.Tensor:
    """xp (B, 4C, h+4, w+4), kc (4C, 100), bias4 (4,) -> (B, 1, 2h, 2w)."""
    if xp.device.type == "cpu":
        return phase_head_plain(xp, kc, bias4)
    cuda_build.require_cuda_tensor(xp, "phase_head xp")
    cuda_build.require_cuda_tensor(kc, "phase_head kc")
    cuda_build.refuse_autograd("phase_head", xp, kc, bias4)
    f32 = xp.dtype == torch.float32
    route = "f32" if f32 else "bf16, wgmma"
    if f32:
        why = _plane_error(xp.shape)
    else:
        why = wgmma_shape_error(xp.shape, xp.dtype)
        if why is None and xp.data_ptr() % 16:
            why = "xp must be 16-byte aligned"
    why = why or _operand_error(xp, kc, bias4)
    if why is not None:
        raise ValueError(f"phase_head ({route}): {why}")
    b, c4, hp, wp = xp.shape
    h, w = hp - 4, wp - 4
    bias = bias4.detach().to(device=xp.device, dtype=torch.float32) \
        .contiguous()
    out = torch.empty(b, 1, 2 * h, 2 * w, dtype=xp.dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    cuda_build.count_work(
        2 * c4 * 100 * h * w * b,
        (xp.numel() + kc.numel() + out.numel()) * xp.element_size()
        + bias.numel() * 4)
    if f32:
        fn = cuda_build.kernel("affg_phase_head_f32", _ARGS_F32)
        with torch.cuda.device(xp.device):
            err = fn(xp.data_ptr(), kc.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), b, c4, h, w, stream)
        cuda_build.check(err, "phase_head (f32)")
        phase_head.launches += 1
        return out
    rows = strip_rows(b, h, _sm_count(xp.device))
    kpack = pack_kc(kc)
    fn = cuda_build.kernel("affg_phase_head_wgmma", _ARGS_WGMMA)
    with torch.cuda.device(xp.device):
        err = fn(xp.data_ptr(), kpack.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, c4, h, w, rows, stream)
    cuda_build.check(err, "phase_head (bf16, wgmma)")
    phase_head.launches_wgmma += 1
    return out


# host calls that launched a route: eager calls and a CUDA graph's warm-up
# and capture, not its replays (``utils/cuda_graphs.py``)
phase_head.launches = 0          # f32 route, CUDA cores
phase_head.launches_wgmma = 0    # bf16 route, wgmma + TMA


def phase_head_fold(xp: torch.Tensor, kc: torch.Tensor,
                    bias4: torch.Tensor) -> torch.Tensor:
    """``phase_head`` with the JAX package's signature and layout
    (``ops/phase_head_pallas.py:phase_head_fold``): the reflect-padded
    phase input xp (B, h+4, w+4, 4C), kc (4C, 100), bias4 (4,) -> the
    tanh'd images (B, 2h, 2w).  xp is transposed into the kernels' NCHW."""
    return phase_head(xp.permute(0, 3, 1, 2).contiguous(), kc, bias4)[:, 0]
