"""AdaIN decoder: (B, 512, 8, 27) content -> (B, 1, 64, 216) word image.

Port of ``affganwriting_tpu/models/decoder.py`` (NCHW): two
AdaIN residual blocks whose second AdaIN site fuses a style-pyramid skip
through iAFF, three 2x upsample + 5x5 conv stages with instance norm + ReLU,
and a 7x7 tanh head.  BatchNorm and the choice below follow the module's
train/eval mode, as the JAX package's ``train`` argument does.

Subpixel mode (default) folds each upsample+conv pair into four 3x3 phase
kernels, keeps the last stage in phase layout (channels packed (p, q, c))
and runs the folded head in phase layout; exact mode upsamples and convolves
at full resolution.  Both share one parameter set.  In eval mode the two
spatial-layout instance norms (and all three in exact mode) run
``ops/in_relu_cuda.in_relu`` and the subpixel head runs
``ops/phase_head_cuda.phase_head``: the CUDA kernels on the card, their
plain versions on the CPU.  The kernels are forward-only, like the JAX
package's Pallas kernels, so in train mode (the JAX gate ``not train``)
the norms are ``relu(instance_norm(x))`` and the head is the einsum and 25
shifted slices of ``fold_head``, all in autograd.

w8a8 serving (``Decoder.set_quant_mode``, JAX ``Decoder(quant=True,
quant_mode=...)``): the four res-block convs and, in subpixel mode, the
three folded upsample convs run through ``ops/quant.py`` with the same
parameters; the norms, iAFF and the head stay in the compute dtype, and
so go through the two kernels as above.  ``"dynamic"``: per-sample scales;
``"calib"``: the float path, recording ``max|x|`` of each site's input over
every call into the site's ``amax`` buffer (JAX ``("quant", "amax")``;
non-persistent, so state dicts do not change); ``"static"``: the int8
conv at the recorded ``amax``, padding the int8 tensor.  Forward-only.

In eval mode with grad off, on the card and in the float path (no int8
conv site), ``Decoder.forward`` replays a CUDA graph captured for each
input signature, at most ``Decoder.MAX_GRAPHS`` (12: the preview's batches
of 1-8 words and the bulk 128 fit) under the spans ``G.dec.capture`` and
``G.dec.replay`` (``utils/cuda_graphs.py``); an int8 mode runs eager and
keeps them, so a float call after a w8a8 call replays.  Both kernels run
inside the graph unchanged.

In eval mode the decoder opens the spans ``G.dec.res`` (both res blocks),
``G.dec.up`` (the upsample stages and their norms) and ``G.dec.head``
(``utils/profiling.span``) in eager calls and inside a capture; a replay
stands for them as ``G.dec.replay``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.aff import AdaINFusion
from affganwriting_torch.models.blocks import (
    Conv2d,
    depth_to_space,
    pad2d,
    with_bias,
)
from affganwriting_torch.ops.in_relu_cuda import in_relu
from affganwriting_torch.ops.norms import instance_norm
from affganwriting_torch.ops.phase_head_cuda import phase_head
from affganwriting_torch.ops.quant import dyn_int8_conv, static_int8_conv
from affganwriting_torch.utils.cuda_graphs import replay_eval_forward
from affganwriting_torch.utils.profiling import span

QUANT_MODES = ("dynamic", "calib", "static")


def _add_amax(site: nn.Module) -> None:
    site.register_buffer("amax", torch.zeros(()), persistent=False)


def record_amax(site: nn.Module, x: torch.Tensor) -> None:
    """``calib`` mode: ``site.amax = max(site.amax, max|x|)``."""
    with torch.no_grad():
        site.amax.copy_(torch.maximum(site.amax, x.float().abs().amax()))


def int8_conv_site(site: nn.Module, mode: str, x, w, bias, out_dtype,
                   pad: int, pad_type: str = "reflect"):
    """One int8 conv site (JAX ``models/decoder.py:_quant_conv_site``): the
    stride-1 VALID conv of x padded by ``pad``, with per-sample scales
    (``"dynamic"``) or at ``site.amax`` (``"static"``)."""
    if mode == "dynamic":
        return dyn_int8_conv(pad2d(x, pad, pad_type), w, bias,
                             out_dtype=out_dtype)
    return static_int8_conv(x, w, site.amax, bias, out_dtype=out_dtype,
                            pad=pad, pad_type=pad_type)


def _phase_fold_matrix(taps: int, offsets: int) -> torch.Tensor:
    """F[p, d, a] = 1 where hi-res tap a (of ``taps``, centred) of output
    phase p lands at low-res offset d (of ``offsets``, centred):
    d = floor((p + a) / 2)."""
    r, s = taps // 2, offsets // 2
    f = torch.zeros(2, offsets, taps)
    for p in (0, 1):
        for a in range(-r, r + 1):
            f[p, (p + a) // 2 + s, a + r] = 1.0
    return f


def _head_fold_matrix() -> torch.Tensor:
    """g[P, d, p, a] = 1 where hi-res tap a of output phase P reads input
    phase p = (P + a) mod 2 at low-res offset d = floor((P + a) / 2)."""
    g = torch.zeros(2, 5, 2, 7)
    for P in (0, 1):
        for a in range(-3, 4):
            g[P, (P + a) // 2 + 2, (P + a) % 2, a + 3] = 1.0
    return g


@functools.cache
def _fold_matrix(kind: str, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The upsample convs' (``"up"``) or the head's (``"head"``) 0/1 fold
    matrix on ``device`` in ``dtype``, copied there once: a copy from host
    memory waits for the stream, and a CUDA graph's capture refuses it.  A
    plain tensor, which autograd may save."""
    with torch.inference_mode(False):
        f = _phase_fold_matrix(5, 3) if kind == "up" else _head_fold_matrix()
        return f.to(device=device, dtype=dtype)


def fold_upsample_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Cin, 5, 5) kernel of nearest-2x + 5x5 conv -> (4*Co, Cin, 3, 3)
    low-res phase kernels, output channel (2p + q)*Co + co:
    out[2m+p, 2n+q] = sum_{a,b} w[a+2, b+2] x[m + floor((p+a)/2),
    n + floor((q+b)/2)]."""
    f = _fold_matrix("up", w.device, w.dtype)
    co, ci = w.shape[:2]
    w4 = torch.einsum("pya,qxb,oiab->pqoiyx", f, f, w)
    return w4.reshape(4 * co, ci, 3, 3)


def split_adain_params(adain_params: torch.Tensor, num_sites: int, dim: int):
    """(B, num_sites*2*dim) -> list of (mean (B, dim), std (B, dim))."""
    out = []
    for i in range(num_sites):
        chunk = adain_params[:, i * 2 * dim:(i + 1) * 2 * dim]
        out.append((chunk[:, :dim], chunk[:, dim:]))
    return out


def instance_norm_phase(x4: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of the logical (2h, 2w) image computed in phase layout:
    x4 (B, 4C, h, w), channels packed (p, q, c); per-(sample, c) statistics
    pool over (p, q, h, w)."""
    b, c4, h, w = x4.shape
    g = x4.reshape(b, 4, c4 // 4, h * w)
    f32 = g.float()
    mean = f32.mean(dim=(1, 3), keepdim=True)
    var = f32.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    scale = torch.rsqrt(var + eps)
    out = (g - mean.to(g.dtype)) * scale.to(g.dtype)
    return out.reshape(b, c4, h, w)


def fold_head_kernel(k: torch.Tensor) -> torch.Tensor:
    """(1, C, 7, 7) head kernel -> tap-major phase kernel (4C, 100):
    kc[(2p+q)*C + c, 4*(5*dy + dx) + 2P + Q] is the weight of input phase
    (p, q) at low-res offset (dy-2, dx-2) for output phase (P, Q)."""
    c = k.shape[1]
    g = _fold_matrix("head", k.device, k.dtype)
    k4 = torch.einsum("PypA,QxqB,cAB->pqcyxPQ", g, g, k[0])
    return k4.reshape(4 * c, 100)


def fold_head(xp: torch.Tensor, kc: torch.Tensor,
              bias4: torch.Tensor) -> torch.Tensor:
    """The phase head as the JAX package computes it without its kernel, in
    xp's dtype: z = xp . kc to tap-major (B, 100, h+4, w+4), the 25 shifted
    slices added in order, bias, tanh, depth-to-space -> (B, 1, 2h, 2w)."""
    b, _, hp, wp = xp.shape
    h, w = hp - 4, wp - 4
    z = torch.einsum("bchw,ck->bkhw", xp, kc)
    y = z.new_zeros(b, 4, h, w)
    for t in range(25):
        dy, dx = divmod(t, 5)
        y = y + z[:, 4 * t:4 * t + 4, dy:dy + h, dx:dx + w]
    y = y + bias4.to(y.dtype).view(1, 4, 1, 1)
    return depth_to_space(torch.tanh(y))


class UpsampleConv(nn.Module):
    """2x nearest upsample + 5x5 reflect-pad conv; ``subpixel`` runs it as
    one low-res 3x3 conv with the folded phase kernels, ``emit_phase``
    skips the final depth-to-space."""

    def __init__(self, cin: int, features: int, subpixel: bool = True,
                 emit_phase: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.subpixel, self.emit_phase, self.dtype = subpixel, emit_phase, dtype
        self.quant_mode: str | None = None     # subpixel mode only
        self.weight = nn.Parameter(torch.empty(features, cin, 5, 5))
        self.bias = nn.Parameter(torch.zeros(features))
        _add_amax(self)

    def forward(self, x):
        dt = self.dtype
        if not self.subpixel:
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            up, w = pad2d(up, 2, "reflect").to(dt), self.weight.to(dt)
            return with_bias(lambda b: F.conv2d(up, w, b), self.bias, dt)
        w4 = fold_upsample_kernel(self.weight)
        bias4 = self.bias.repeat(4)
        if self.quant_mode == "calib":
            record_amax(self, x)
        if self.quant_mode in ("dynamic", "static"):
            y = int8_conv_site(self, self.quant_mode, x, w4, None, dt, pad=1)
            y = y + bias4.to(dt).view(1, -1, 1, 1)
        else:
            xp, w = pad2d(x, 1, "reflect").to(dt), w4.to(dt)
            y = with_bias(lambda b: F.conv2d(xp, w, b), bias4, dt)
        return y if self.emit_phase else depth_to_space(y)


class PhaseHead(nn.Module):
    """7x7 conv + tanh head consuming phase layout, one output channel.

    The (1, C, 7, 7) kernel is folded into a tap-major (4C, 100) kernel,
    the phase tensor is reflect-padded by 2, and ``phase_head`` computes
    tanh of the folded conv with the depth-to-space fused."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(1, channels, 7, 7))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x4):
        kc = fold_head_kernel(self.weight)
        xp = pad2d(x4, 2, "reflect").to(self.dtype)  # (B, 4C, h+4, w+4)
        if self.training:
            return fold_head(xp, kc.to(self.dtype), self.bias.repeat(4))
        return phase_head(xp.contiguous(), kc.to(self.dtype),
                          self.bias.repeat(4))


class ExactHead(nn.Module):
    """7x7 reflect-pad conv + tanh on spatial layout; same parameters as
    ``PhaseHead``."""

    def __init__(self, channels: int, pad_type: str = "reflect",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pad_type, self.dtype = pad_type, dtype
        self.weight = nn.Parameter(torch.empty(1, channels, 7, 7))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        y = F.conv2d(pad2d(x, 3, self.pad_type).to(self.dtype),
                     self.weight.to(self.dtype))
        return torch.tanh(y + self.bias.to(self.dtype))


class AdaINResBlock(nn.Module):
    """Residual block whose two 3x3 convs are followed by AdaIN sites; the
    second site fuses a style skip."""

    def __init__(self, dim: int = 512, pad_type: str = "reflect",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pad_type = pad_type
        self.quant_mode: str | None = None
        self.conv0 = Conv2d(dim, dim, 3, compute_dtype=dtype)
        self.adain0 = AdaINFusion(dim, dtype)
        self.conv1 = Conv2d(dim, dim, 3, compute_dtype=dtype)
        self.adain1 = AdaINFusion(dim, dtype, fuse_skip=True)
        _add_amax(self.conv0)
        _add_amax(self.conv1)

    def _conv(self, conv: Conv2d, h):
        if self.quant_mode == "calib":
            record_amax(conv, h)
        if self.quant_mode in ("dynamic", "static"):
            return int8_conv_site(conv, self.quant_mode, h, conv.weight,
                                  conv.bias, conv.compute_dtype, pad=1,
                                  pad_type=self.pad_type)
        return conv(pad2d(h, 1, self.pad_type))

    def forward(self, x, params0, params1, skip1):
        h = self._conv(self.conv0, x)
        h = torch.relu(self.adain0(h, *params0))
        h = self._conv(self.conv1, h)
        h = self.adain1(h, *params1, skip=skip1)
        return x + h


@replay_eval_forward("G.dec", max_graphs=12,
                     when=lambda dec: all(m.quant_mode is None
                                          for m in dec._quant_blocks()))
class Decoder(nn.Module):
    def __init__(self, dim: int = 512, ups: int = 3, pad_type: str = "reflect",
                 subpixel_upsample: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.ups, self.subpixel = dim, ups, subpixel_upsample
        self.res0 = AdaINResBlock(dim, pad_type, dtype)
        self.res1 = AdaINResBlock(dim, pad_type, dtype)
        d = dim
        for i in range(ups):
            last = i == ups - 1
            self.add_module(f"up{i}", UpsampleConv(
                d, d // 2, subpixel=subpixel_upsample,
                emit_phase=subpixel_upsample and last, dtype=dtype))
            d //= 2
        self.head = (PhaseHead(d, dtype) if subpixel_upsample
                     else ExactHead(d, pad_type, dtype))

    def quant_sites(self) -> dict[str, nn.Module]:
        """The int8 conv sites by their JAX ``"quant"`` collection paths
        (``res0/conv0``, ..., ``up2``), each holding an ``amax`` buffer."""
        sites = {f"res{r}/conv{c}": getattr(getattr(self, f"res{r}"),
                                            f"conv{c}")
                 for r in (0, 1) for c in (0, 1)}
        if self.subpixel:
            sites.update({f"up{i}": getattr(self, f"up{i}")
                          for i in range(self.ups)})
        return sites

    def _quant_blocks(self) -> tuple[nn.Module, ...]:
        return (self.res0, self.res1,
                *(getattr(self, f"up{i}") for i in range(self.ups)))

    def set_quant_mode(self, mode: str | None) -> None:
        """None (the float path) or one of ``QUANT_MODES`` for every conv
        site; eval mode only.  The float path's graphs are kept: the
        replay predicate keeps every int8 mode eager, and a float-path graph
        reads the weights by address and never an ``amax``."""
        if mode is not None and mode not in QUANT_MODES:
            raise ValueError(f"unknown quant_mode {mode!r}")
        for m in self._quant_blocks():
            m.quant_mode = mode

    def forward(self, content: torch.Tensor, adain_params: torch.Tensor,
                style_pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
        with span("G.dec.res", not self.training):
            sites = split_adain_params(adain_params, 4, self.dim)
            skip1 = F.max_pool2d(style_pyramid[3], 2, 2)
            skip3 = style_pyramid[4]
            x = self.res0(content, sites[0], sites[1], skip1)
            x = self.res1(x, sites[2], sites[3], skip3)
        return self.up_chain(x)

    def up_chain(self, x: torch.Tensor) -> torch.Tensor:
        """The upsample convs, their instance norms + ReLU (``in_relu`` in
        eval mode) and the head: (B, dim, h, w) -> (B, 1, 8h, 8w)."""
        serving = not self.training
        with span("G.dec.up", serving):
            for i in range(self.ups):
                x = getattr(self, f"up{i}")(x)
                if self.subpixel and i == self.ups - 1:
                    x = torch.relu(instance_norm_phase(x))
                elif self.training:
                    x = torch.relu(instance_norm(x))
                else:
                    x = in_relu(x.contiguous())
        with span("G.dec.head", serving):
            return self.head(x)
