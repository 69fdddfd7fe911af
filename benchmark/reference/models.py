"""The plain reference of the word GAN's four players, in float32.

A frozen copy, in plain PyTorch, of the mathematics of the port's G (the
text encoder, the split mix and the AdaIN/iAFF decoder with its folded
subpixel upsampling, around a style encoder), R, D and C.  It imports
nothing of the program: the benchmark hands it the same inputs and weights
it hands the program, under the program's parameter names, and it computes
everything again.  No CUDA kernel, cache or batching trick: instance norm
plus ReLU is two plain ops, the 7x7 tanh head one plain convolution of the
folded kernel.

G's style encoder and R are parts, each in a file of its own that
``part`` finds by the configuration's name: ``style_<style_encoder>.py``
and ``rec_<recognizer>.py`` beside this module.  A style part's
``build(cfg)`` returns the encoder, whose forward maps the NCHW stack to
the five maps the decoder reads; a recognizer part's ``build(cfg, p)``
returns R, whose ``forward(img, labels, gen=None, feed=None)`` gives the
per-step logits (B, T - 1, V), fed ``feed`` where given and its own greedy
ids where not.  Its ``Tap(rec, cfg)`` hooks an R, the program's in any of
its modes or the reference's (``tap``): ``take()`` returns a function that
gives, for each call of R since the last take, the logits (B, T - 1, V) as
R computed them and the ids (B, T - 1) it fed itself, and launches nothing
until that function is called; ``remove()`` takes the hooks off.  This
module keeps what the parts share: the layers, the DINOv2-style ViT
family, G's text encoder, mix and decoder, D and C.

Every convolution and dense layer passes its input and weight through
``Layer.cast``, the identity for the reference.  ``set_cast`` swaps it for
the control, the reference rounded to a lower precision
(``fp8_round``).
"""

from __future__ import annotations

import functools
import importlib
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

VOCAB_PAD = 2


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Layer(nn.Module):
    """A layer whose operands go through ``self.cast``."""

    cast = staticmethod(identity)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude onto 448, e4m3's largest), returned in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def set_cast(model: nn.Module, cast) -> nn.Module:
    """Route every layer of ``model`` through ``cast``."""
    for m in model.modules():
        if isinstance(m, Layer):
            m.cast = cast
    return model


class Conv(Layer):
    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True):
        super().__init__()
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, *k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(self.cast(x), self.cast(self.weight), self.bias,
                        self.stride, self.padding)


class Dense(Layer):
    def __init__(self, din, dout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        return F.linear(self.cast(x), self.cast(self.weight), self.bias)


class BatchNorm(nn.Module):
    """flax BatchNorm: batch mean and max(0, E[x^2] - E[x]^2) in train mode,
    running statistics moved by 0.9 r + 0.1 batch (biased variance) unless
    ``frozen``; the running statistics in eval mode."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps, self.frozen = eps, False
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(dims)
            var = (x.square().mean(dims) - mean.square()).clamp_min(0.0)
            if not self.frozen:
                with torch.no_grad():
                    self.running_mean.mul_(0.9).add_(0.1 * mean)
                    self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def pad2d(x, p, mode="reflect"):
    if p == 0:
        return x
    if mode == "reflect" and min(x.shape[2:]) == 1:
        for dim, pad in ((2, (0, 0, p, p)), (3, (p, p, 0, 0))):
            x = F.pad(x, pad, mode="reflect" if x.shape[dim] > 1
                      else "replicate")
        return x
    return F.pad(x, (p,) * 4, mode=mode)


def resize_bilinear(x, size):
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=shrink)


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.square().mean(dim=(2, 3), keepdim=True) - mean.square()
    return (x - mean) * torch.rsqrt(var + eps)


def depth_to_space(x):
    b, c4, h, w = x.shape
    c = c4 // 4
    return (x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            .reshape(b, c, 2 * h, 2 * w))


def dropout(x, p, gen, channels=False):
    """flax Dropout: the mask is ``rand < 1 - p`` drawn from ``gen`` in the
    program's order and shapes, so one generator state gives one mask."""
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    keep = torch.rand(tuple(shape), generator=gen, device=x.device) < 1 - p
    return torch.where(keep, x / (1 - p), x.new_zeros(()))


# ---------------------------------------------------------------- G ------

class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-6)


class Attention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        for n in ("query", "key", "value", "out"):
            self.add_module(n, Dense(d, d))

    def forward(self, x):
        n, t, d = x.shape
        hd = d // self.heads

        def split(h):
            return h.view(n, t, self.heads, hd).transpose(1, 2)

        q, k, v = (split(f(x)) for f in (self.query, self.key, self.value))
        a = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
        return self.out((a @ v).transpose(1, 2).reshape(n, t, d))


class ViTBlock(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.norm1, self.attn = LayerNorm(d), Attention(d, heads)
        self.norm2 = LayerNorm(d)
        self.mlp_fc1, self.mlp_fc2 = Dense(d, 4 * d), Dense(4 * d, d)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh")
        return x + self.mlp_fc2(h)


class ViTEncoder(nn.Module):
    """DINOv2-style ViT: patch 14 over the edge-padded stack, no CLS token,
    no LayerScale, tapped at the stem and at ``taps``."""

    def __init__(self, dim, depth, heads, taps, cin=50, style_dim=512,
                 final_hw=(8, 27), patch=14):
        super().__init__()
        self.final_hw, self.patch, self.depth = tuple(final_hw), patch, depth
        self.taps = tuple(taps)
        h, w = 8 * final_hw[0], 8 * final_hw[1]
        tokens = -(-h // patch) * -(-w // patch)
        self.patch_embed = Conv(cin, dim, patch, patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads))
        for i in range(len(self.taps) + 1):
            self.add_module(f"reduce{i}", Conv(dim, style_dim, 1))

    def forward(self, x):
        n, _, h, w = x.shape
        p = self.patch
        x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p),
                  mode="replicate")
        t = self.patch_embed(x)
        hp, wp = t.shape[2:]
        t = t.flatten(2).transpose(1, 2) + self.pos_embed
        d = t.shape[2]

        def to_map(z):
            return z.transpose(1, 2).reshape(n, d, hp, wp)

        maps = [to_map(t)]
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t)
            if i in self.taps:
                maps.append(to_map(t))
        out = [getattr(self, f"reduce{i}")(m) for i, m in enumerate(maps)]
        out[-1] = resize_bilinear(out[-1], self.final_hw)
        return out



class TextEncoder(nn.Module):
    def __init__(self, max_len=12, vocab=55, embed=64, content=512,
                 adain=4096):
        super().__init__()
        self.embed = nn.Embedding(vocab, embed)
        self.fc0 = Dense(max_len * embed, 1024)
        self.BatchNorm_0 = BatchNorm(1024)
        self.fc1, self.BatchNorm_1 = Dense(1024, 2048), BatchNorm(2048)
        self.fc2 = Dense(2048, adain)
        self.linear = Dense(embed, content)

    def forward(self, labels, hw):
        b, t = labels.shape
        h, w = hw
        xx = F.embedding(labels, self.embed.weight)
        out = torch.relu(self.BatchNorm_0(self.fc0(xx.reshape(b, -1))))
        out = torch.relu(self.BatchNorm_1(self.fc1(out)))
        out = self.fc2(out)
        body = self.linear(xx).repeat_interleave(max(1, w // t), dim=1)
        pad_cols = w - body.shape[1]
        if pad_cols > 0:
            pad = torch.full((1, 1), VOCAB_PAD, dtype=labels.dtype,
                             device=labels.device)
            pad_vec = self.linear(F.embedding(pad, self.embed.weight))
            body = torch.cat([body, pad_vec.expand(b, pad_cols, -1)], dim=1)
        else:
            body = body[:, :w]
        return out, body.transpose(1, 2)[:, :, None, :].expand(-1, -1, h, -1)


class SplitMix(Layer):
    def __init__(self, ds, dc, f):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(f, ds + dc))
        self.bias = nn.Parameter(torch.zeros(f))

    def forward(self, style, content):
        ds = style.shape[1]
        k = self.cast(self.weight)
        return (torch.einsum("bchw,fc->bfhw", self.cast(style), k[:, :ds])
                + torch.einsum("bchw,fc->bfhw", self.cast(content), k[:, ds:])
                + self.bias.view(1, -1, 1, 1))


def adain(x, mean, std):
    return instance_norm(x) * std[:, :, None, None] + mean[:, :, None, None]


def mean_variance_norm(x, eps=1e-5):
    n = x.shape[2] * x.shape[3]
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    if n > 1:
        var = var * (n / (n - 1))
    return (x - mean) / torch.sqrt(var + eps)


class AttBranch(nn.Module):
    def __init__(self, c, inter):
        super().__init__()
        self.Conv_0, self.BatchNorm_0 = Conv(c, inter, 1), BatchNorm(inter)
        self.Conv_1, self.BatchNorm_1 = Conv(inter, c, 1), BatchNorm(c)

    def forward(self, x):
        return self.BatchNorm_1(self.Conv_1(
            torch.relu(self.BatchNorm_0(self.Conv_0(x)))))


class IAFF(nn.Module):
    def __init__(self, c=512, r=4):
        super().__init__()
        self.local_att = AttBranch(c, c // r)
        self.global_att = AttBranch(c, c // r)
        self.local_att2 = AttBranch(c, c // r)

    def forward(self, x, res):
        def gap(h):
            return h.mean(dim=(2, 3), keepdim=True)

        xa = x + res
        wei = torch.sigmoid(self.local_att(xa) + self.global_att(gap(xa)))
        xi = x * wei + res * (1 - wei)
        wei2 = torch.sigmoid(self.local_att2(xi) + self.global_att(gap(xi)))
        return x * wei2 + res * (1 - wei2)


class AdaINFusion(nn.Module):
    def __init__(self, c, fuse):
        super().__init__()
        if fuse:
            self.iaff = IAFF(c)

    def forward(self, x, mean, std, skip=None):
        if skip is not None:
            key = F.interpolate(skip, size=x.shape[2:], mode="nearest-exact")
            x = self.iaff(x, mean_variance_norm(key))
        return adain(x, mean, std)


class AdaINResBlock(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.conv0, self.adain0 = Conv(d, d, 3), AdaINFusion(d, False)
        self.conv1, self.adain1 = Conv(d, d, 3), AdaINFusion(d, True)

    def forward(self, x, p0, p1, skip):
        h = torch.relu(self.adain0(self.conv0(pad2d(x, 1)), *p0))
        h = self.adain1(self.conv1(pad2d(h, 1)), *p1, skip=skip)
        return x + h


def _fold_matrix(taps, offsets):
    r, s = taps // 2, offsets // 2
    f = torch.zeros(2, offsets, taps)
    for p in (0, 1):
        for a in range(-r, r + 1):
            f[p, (p + a) // 2 + s, a + r] = 1.0
    return f


class UpsampleConv(Layer):
    """Nearest 2x upsample and a 5x5 conv, folded as the program's subpixel
    mode folds it: four 3x3 phase kernels on the reflect-padded low-res
    map, output channels packed (p, q, c)."""

    def __init__(self, cin, f, emit_phase):
        super().__init__()
        self.emit_phase = emit_phase
        self.weight = nn.Parameter(torch.empty(f, cin, 5, 5))
        self.bias = nn.Parameter(torch.zeros(f))

    def forward(self, x):
        fm = _fold_matrix(5, 3).to(self.weight)
        co, ci = self.weight.shape[:2]
        w4 = torch.einsum("pya,qxb,oiab->pqoiyx", fm, fm, self.weight)
        y = F.conv2d(self.cast(pad2d(x, 1)),
                     self.cast(w4.reshape(4 * co, ci, 3, 3)),
                     self.bias.repeat(4))
        return y if self.emit_phase else depth_to_space(y)


class PhaseHead(Layer):
    """The 7x7 tanh head on the phase layout: one 5x5 convolution of the
    phase tensor, reflect-padded by 2, with the folded kernel, into the
    four output phases, then tanh and depth-to-space."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, c, 7, 7))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x4):
        c = self.weight.shape[1]
        g = torch.zeros(2, 5, 2, 7)
        for P in (0, 1):
            for a in range(-3, 4):
                g[P, (P + a) // 2 + 2, (P + a) % 2, a + 3] = 1.0
        g = g.to(self.weight)
        # k[P, Q, p, q, c, dy, dx]: output phase (P, Q) from input phase
        # (p, q), channel c, at low-res offset (dy - 2, dx - 2)
        k = torch.einsum("PypA,QxqB,cAB->PQpqcyx", g, g, self.weight[0])
        y = F.conv2d(self.cast(pad2d(x4, 2)),
                     self.cast(k.reshape(4, 4 * c, 5, 5)),
                     self.bias.repeat(4))
        return depth_to_space(torch.tanh(y))


def instance_norm_phase(x4, eps=1e-5):
    b, c4, h, w = x4.shape
    g = x4.reshape(b, 4, c4 // 4, h * w)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    return ((g - mean) * torch.rsqrt(var + eps)).reshape(b, c4, h, w)


class Decoder(nn.Module):
    def __init__(self, d=512, ups=3):
        super().__init__()
        self.d, self.ups = d, ups
        self.res0, self.res1 = AdaINResBlock(d), AdaINResBlock(d)
        for i in range(ups):
            self.add_module(f"up{i}", UpsampleConv(d, d // 2, i == ups - 1))
            d //= 2
        self.head = PhaseHead(d)

    def forward(self, content, params, pyramid):
        d = self.d
        sites = [(params[:, 2 * d * i:2 * d * i + d],
                  params[:, 2 * d * i + d:2 * d * (i + 1)]) for i in range(4)]
        x = self.res0(content, sites[0], sites[1],
                      F.max_pool2d(pyramid[3], 2, 2))
        x = self.res1(x, sites[2], sites[3], pyramid[4])
        for i in range(self.ups):
            x = getattr(self, f"up{i}")(x)
            x = torch.relu(instance_norm_phase(x) if i == self.ups - 1
                           else instance_norm(x))
        return self.head(x)


class Generator(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        sd = cfg["style_dim"]
        self.enc_image = part("style", cfg["style_encoder"]).build(cfg)
        self.text_encoder = TextEncoder(cfg["max_chars"] + 2, 55,
                                        cfg["text_embed_dim"], sd,
                                        cfg["adain_param_dim"])
        self.dec = Decoder(sd)
        self.linear_mix = SplitMix(sd, sd, sd)

    def encode_style(self, style_nhwc):
        return self.enc_image(style_nhwc.permute(0, 3, 1, 2))

    def generate(self, pyramid, labels):
        """-> images (B, 1, H, W)"""
        adain_params, content = self.text_encoder(labels, pyramid[-1].shape[2:])
        return self.dec(self.linear_mix(pyramid[-1], content), adain_params,
                        pyramid)


# ------------------------------------------------------------ D and C ----

def leaky(x):
    return F.leaky_relu(x, 0.2)


class Conv2dBlock(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, act=True,
                 act_first=False, bias=True, pad_mode="reflect"):
        super().__init__()
        self.pad, self.pad_mode = pad, pad_mode
        self.act, self.act_first = act, act_first
        self.Conv_0 = Conv(cin, cout, k, stride, bias=bias)

    def forward(self, x):
        if self.act and self.act_first:
            x = leaky(x)
        x = self.Conv_0(pad2d(x, self.pad, self.pad_mode))
        if self.act and not self.act_first:
            x = leaky(x)
        return x


class ActFirstResBlock(nn.Module):
    def __init__(self, fin, fout):
        super().__init__()
        fh = min(fin, fout)
        self.Conv2dBlock_0 = Conv2dBlock(fin, fh, 3, 1, 1, act_first=True)
        self.Conv2dBlock_1 = Conv2dBlock(fh, fout, 3, 1, 1, act_first=True)
        if fin != fout:
            self.Conv2dBlock_2 = Conv2dBlock(fin, fout, 1, act=False,
                                             bias=False)

    def forward(self, x):
        dx = self.Conv2dBlock_1(self.Conv2dBlock_0(x))
        if hasattr(self, "Conv2dBlock_2"):
            x = self.Conv2dBlock_2(x)
        return x + dx


class ConvPyramid(nn.Module):
    def __init__(self, n=6, nf=16, max_nf=1024):
        super().__init__()
        self.stem = Conv2dBlock(1, nf, 7, 1, 3, act=False)
        self.stages = []
        for i in range(n):
            tag = f"res{i}" if i < n - 1 else "res_final_"
            nf_out = min(2 * nf, max_nf)
            self.add_module(tag + "a", ActFirstResBlock(nf, nf))
            self.add_module(tag + "b", ActFirstResBlock(nf, nf_out))
            self.stages.append((tag, i < n - 1))
            nf = nf_out
        self.out_channels = nf

    def forward(self, x):
        h = self.stem(x)
        for tag, pooled in self.stages:
            h = getattr(self, tag + "b")(getattr(self, tag + "a")(h))
            if pooled:
                h = F.avg_pool2d(pad2d(h, 1), 3, 2)
        return h


class PatchNet(nn.Module):
    """D (``cout`` = its final size) or C (``cout`` = the writers): the
    pyramid and the act-first patch head, flattened (h, w, c)."""

    def __init__(self, cfg: dict, cout: int):
        super().__init__()
        n = cfg["dis_layers"]
        self.cnn_f = ConvPyramid(n)
        ks = cfg["img_height"] // 2 ** (n - 1)
        st = cfg["img_width"] // 2 ** (n - 1) + 1
        self.cnn_c = Conv2dBlock(self.cnn_f.out_channels, cout, ks, st,
                                 act_first=True)

    def forward(self, x):
        h = self.cnn_c(self.cnn_f(x))
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


@functools.cache
def part(kind: str, name: str):
    """The module of a part: ``<kind>_<name>.py`` beside this file, where
    ``kind`` is ``style`` or ``rec``."""
    path = Path(__file__).resolve().parent / f"{kind}_{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} part named {name!r} ({path})")
    return importlib.import_module(f"{__package__}.{path.stem}")


def style_args(cfg: dict) -> dict:
    """A style encoder's stack channels, output width and last map's size."""
    return dict(cin=cfg["style_stack"], style_dim=cfg["style_dim"],
                final_hw=(cfg["img_height"] // 8, cfg["img_width"] // 8))


def tap(cfg: dict, rec: nn.Module):
    """The tap of ``cfg``'s recognizer part on ``rec``: the program's R in
    any of its modes, or the reference's."""
    return part("rec", cfg["recognizer"]).Tap(rec, cfg)


def build(cfg: dict, which: str, p: float = 0.5) -> nn.Module:
    """One player of ``cfg`` (the configuration file's ``config``), with
    empty weights: ``gen``, ``rec``, ``dis`` or ``cla``; R's dropout
    rate ``p``."""
    if which == "gen":
        return Generator(cfg)
    if which == "rec":
        return part("rec", cfg["recognizer"]).build(cfg, p)
    if which == "dis":
        return PatchNet(cfg, cfg["dis_final_size"])
    if which == "cla":
        return PatchNet(cfg, cfg["num_writers"])
    raise ValueError(which)
