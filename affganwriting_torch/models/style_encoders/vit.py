"""DINOv2-style ViT style encoders ("dinov2_s/b/l/g" registry keys).

Port of ``affganwriting_tpu/models/style_encoders/vit.py`` (the reference's
``ImageEncoderDINOv2``, GAN_word/dinomodel.py:7-166): a patch-14 ViT whose
patch-embedding conv takes the 50-channel style stack, edge-padded to a
multiple of the patch (64x216 -> 70x224, 5x16 tokens), tapped at the stem
and at the blocks ``_ARCHS[arch]["taps"]``; each tap's tokens become an
NCHW map, reduced to ``style_dim`` by a 1x1 conv, the last resized to
``final_hw``.

flax's semantics: LayerNorm at eps 1e-6 in f32, cast to the compute dtype;
``nn.gelu``'s tanh approximation; attention with biases on q, k, v and
out, q scaled by 1/sqrt(head dim) (``F.scaled_dot_product_attention``);
``pos_embed`` added in the compute dtype.  The attention is plain PyTorch:
it is no Pallas kernel in the JAX package either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import Conv2d, Linear, resize_bilinear
from affganwriting_torch.models.style_encoders import register

_ARCHS = {
    "s": dict(embed=384, depth=12, heads=6, taps=(2, 5, 8, 11)),
    "b": dict(embed=768, depth=12, heads=12, taps=(2, 5, 8, 11)),
    "l": dict(embed=1024, depth=24, heads=16, taps=(4, 8, 16, 23)),
    "g": dict(embed=1536, depth=40, heads=24, taps=(9, 19, 29, 39)),
}


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=f32)``: eps 1e-6, f32 out."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over ``dim`` features; the
    q, k, v weights are (heads * head_dim, dim), ``out`` (dim, heads *
    head_dim), head-major as flax's (dim, heads, head_dim) kernels."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Linear(dim, dim, compute_dtype=dtype))

    def forward(self, x):
        n, t, d = x.shape

        def split(h):
            return h.view(n, t, self.heads, d // self.heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(n, t, d))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 mlp_ratio: int = 4):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, dim * mlp_ratio, compute_dtype=dtype)
        self.mlp_fc2 = Linear(dim * mlp_ratio, dim, compute_dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x).to(self.dtype))
        h = self.mlp_fc1(self.norm2(x).to(self.dtype))
        return x + self.mlp_fc2(F.gelu(h, approximate="tanh"))


class ViTStyleEncoder(nn.Module):
    """``arch`` is a key of ``_ARCHS``.  ``pos_embed`` covers the tokens of
    the image the generator feeds, ``8 * final_hw``."""

    def __init__(self, in_channels: int = 50, style_dim: int = 512,
                 final_hw: tuple[int, int] = (8, 27),
                 dtype: torch.dtype = torch.bfloat16, arch: str = "s",
                 patch: int = 14):
        super().__init__()
        spec = _ARCHS[arch]
        dim = spec["embed"]
        self.final_hw, self.dtype, self.patch = tuple(final_hw), dtype, patch
        self.depth, self.taps = spec["depth"], spec["taps"]
        h, w = 8 * final_hw[0], 8 * final_hw[1]
        n_tokens = -(-h // patch) * -(-w // patch)
        self.patch_embed = Conv2d(in_channels, dim, patch, stride=patch,
                                  compute_dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, dim))
        for i in range(spec["depth"]):
            self.add_module(f"block{i}", Block(dim, spec["heads"], dtype))
        for i in range(len(self.taps) + 1):
            self.add_module(f"reduce{i}",
                            Conv2d(dim, style_dim, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        n, _, h, w = x.shape
        p = self.patch
        x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p),
                  mode="replicate")
        tokens = self.patch_embed(x)
        hp, wp = tokens.shape[2:]
        tokens = tokens.flatten(2).transpose(1, 2)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        dim = tokens.shape[2]

        def to_map(t):
            return t.transpose(1, 2).reshape(n, dim, hp, wp)

        maps = [to_map(tokens)]
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in self.taps:
                maps.append(to_map(tokens))
        results = [getattr(self, f"reduce{i}")(m) for i, m in enumerate(maps)]
        results[-1] = resize_bilinear(results[-1],
                                      self.final_hw).to(self.dtype)
        return results


@register("dinov2_s")
class ViTSmall(ViTStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__(arch="s", **kwargs)


@register("dinov2_b")
class ViTBase(ViTStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__(arch="b", **kwargs)


@register("dinov2_l")
class ViTLarge(ViTStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__(arch="l", **kwargs)


@register("dinov2_g")
class ViTGiant(ViTStyleEncoder):
    def __init__(self, **kwargs):
        super().__init__(arch="g", **kwargs)
