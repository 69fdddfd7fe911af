"""Character-aware style encoder (the single-style path).

Port of ``affganwriting_tpu/models/line/char_style.py``: a conv trunk
squeezes the line to a height-1 strip (B, T, C); the recognizer's
log-probabilities, aligned to the strip, pick the ``max_chars`` strongest
non-blank columns; +-``window`` patches around them go through that
character's private extractor (``CharExtractorBank``: the extractors'
parameters stacked (n_class, ...) in the flax layout and gathered per
column); their styles are averaged weighted by recognition score and
fused with a global branch into one style vector.

Ties: the columns are taken by a stable descending sort, so equal scores
keep the lower column first, as ``lax.top_k`` does (``torch.topk``
promises no order among ties).  The GroupNorms keep flax's automatic
names (``GroupNorm_0``..``_6``) so that the flax tree converts as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import (
    Conv2d,
    GroupNorm,
    get_group_size,
)


def group_norm_banked(x, scale, bias, groups: int, eps: float = 1e-5):
    """GroupNorm of x (B, N, T, C) over (T, channels of a group) with per
    (b, n) affine parameters scale/bias (B, N, C), in f32."""
    b, n, t, c = x.shape
    xg = x.reshape(b, n, t, groups, c // groups).float()
    mean = xg.mean(dim=(2, 4), keepdim=True)
    var = xg.var(dim=(2, 4), keepdim=True, correction=0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, n, t, c)
    return out * scale[:, :, None, :] + bias[:, :, None, :]


def top_columns(scores: torch.Tensor, n: int):
    """The ``n`` largest of each row of ``scores`` (B, T) and their
    indices, equal scores in ascending index order (``lax.top_k``)."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :n], idx[:, :n]


def select_columns(recog: torch.Tensor, max_chars: int):
    """The strongest non-blank columns of log-probs (B, T, K): (indices
    (B, N), classes (B, N), weights (B, N): the confidence where the column
    is non-blank, else 0), N = min(max_chars, T)."""
    score, pred = recog.max(dim=-1)
    score = torch.exp(score)
    masked = torch.where(pred != 0, score, torch.full_like(score, -1.0))
    top_score, top_idx = top_columns(masked, min(max_chars, recog.shape[1]))
    classes = pred.gather(1, top_idx)
    weights = torch.where(top_score > 0.0, top_score,
                          torch.zeros_like(top_score))
    return top_idx, classes, weights


def gather_windows(seq: torch.Tensor, idx: torch.Tensor,
                   window: int) -> torch.Tensor:
    """+-``window`` patches (B, N, 2w+1, C) of seq (B, T, C) around the
    columns ``idx`` (B, N), zero beyond the ends."""
    b, n = idx.shape
    c = seq.shape[-1]
    padded = F.pad(seq, (0, 0, window, window))
    offsets = torch.arange(2 * window + 1, device=seq.device)
    flat = (idx[:, :, None] + offsets).reshape(b, -1)
    return padded.gather(1, flat[..., None].expand(-1, -1, c)).reshape(
        b, n, 2 * window + 1, c)


class CharExtractorBank(nn.Module):
    """All ``n_class`` character extractors (the 'small' variant) as
    stacked parameters, applied per column by class-indexed gather:
    patches (B, N, W, in_dim), class_idx (B, N) -> (B, N, style_dim)."""

    def __init__(self, n_class: int, in_dim: int = 256, dim: int = 128,
                 style_dim: int = 128):
        super().__init__()
        k, cin, d, out = n_class, in_dim, dim, style_dim
        self.dim = d
        shapes = {"w1": (k, 3, cin, d), "b1": (k, d), "g1s": (k, d),
                  "g1b": (k, d), "w2": (k, 3, d, cin), "b2": (k, cin),
                  "w3": (k, cin, 2 * d), "b3": (k, 2 * d),
                  "g2s": (k, 2 * d), "g2b": (k, 2 * d),
                  "wf1": (k, 2 * d, 2 * d), "bf1": (k, 2 * d),
                  "wf2": (k, 2 * d, out), "bf2": (k, out)}
        for name, shape in shapes.items():
            init = torch.ones if name in ("g1s", "g2s") else torch.zeros
            self.register_parameter(name, nn.Parameter(init(shape)))

    def forward(self, patches, class_idx):
        def take(name):
            return getattr(self, name)[class_idx]          # (B, N, ...)

        def conv3(h, w, b):
            # per-column 'same' conv, kernel 3: (B,N,T,Ci) x (B,N,3,Ci,Co)
            t = h.shape[2]
            hp = F.pad(h, (0, 0, 1, 1))
            taps = torch.stack([hp[:, :, i:i + t] for i in range(3)], 2)
            return torch.einsum("bndtc,bndco->bnto", taps, w) \
                + b[:, :, None, :]

        d = self.dim
        x = patches.float()
        h = conv3(torch.relu(x), take("w1"), take("b1"))
        h = torch.relu(group_norm_banked(h, take("g1s"), take("g1b"),
                                         get_group_size(d)))
        h = conv3(h, take("w2"), take("b2")) + x
        h = torch.einsum("bntc,bnco->bnto", torch.relu(h), take("w3")) \
            + take("b3")[:, :, None]
        h = torch.relu(group_norm_banked(h, take("g2s"), take("g2b"),
                                         get_group_size(2 * d)))
        h = h.mean(dim=2)                                  # (B, N, 2d)
        h = torch.relu(torch.einsum("bnc,bnco->bno", h, take("wf1"))
                       + take("bf1"))
        return torch.einsum("bnc,bnco->bno", h, take("wf2")) + take("bf2")


class CharStyleEncoder(nn.Module):
    """image (B, 1, H, W), recog (B, T_r, n_class) log-probs -> the fused
    style (B, style_dim)."""

    # (name, kernel, stride, (pad h, pad w), norm + ReLU) of the trunk
    _DOWN = (("down0", 5, (1, 1), (2, 2), True),
             ("down0a", 4, (2, 2), (1, 1), True),
             ("down0b", 3, (1, 1), (0, 1), True),
             ("down1a", 4, (2, 2), (1, 1), True),
             ("down1b", 3, (1, 1), (0, 1), True),
             ("down3", 4, (2, 1), (0, 1), True),
             ("down4", 4, (2, 1), (0, 1), False))

    def __init__(self, n_class: int = 80, dim: int = 64,
                 style_dim: int = 128, char_dim: int = 128, window: int = 2,
                 max_chars: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.max_chars = window, max_chars
        widths = (dim, 2 * dim, 2 * dim, 4 * dim, 4 * dim, 4 * dim, 4 * dim)
        cin, g = 1, 0
        for (name, k, s, _, norm), cout in zip(self._DOWN, widths):
            self.add_module(name, Conv2d(cin, cout, k, stride=s,
                                         compute_dtype=dtype))
            if norm:
                self.add_module(f"GroupNorm_{g}",
                                GroupNorm(get_group_size(cout), cout))
                g += 1
            cin = cout
        c = cin
        self.char_extractor = CharExtractorBank(n_class, c, char_dim,
                                                style_dim)
        self.prep0 = nn.Conv1d(c + n_class, c, 5, padding=2)
        self.prep1 = nn.Conv1d(c, c, 3, padding=1)
        self.GroupNorm_6 = GroupNorm(get_group_size(c), c)    # prep1's
        self.prep2 = nn.Conv1d(c, c, 3, padding=1)
        self.final0 = nn.Linear(c + style_dim, c)
        self.final1 = nn.Linear(c, style_dim)

    def strip(self, image: torch.Tensor) -> torch.Tensor:
        """The trunk: (B, 1, H, W) -> a (B, T, C) strip."""
        x, g = image, 0
        for name, _, _, (ph, pw), norm in self._DOWN:
            x = getattr(self, name)(F.pad(x, (pw, pw, ph, ph)))
            if norm:
                x = torch.relu(getattr(self, f"GroupNorm_{g}")(x).to(x.dtype))
                g += 1
        return (x[:, :, 0] if x.shape[2] == 1 else x.mean(2)).transpose(1, 2)

    def forward(self, image, recog):
        strip = self.strip(image)
        t = strip.shape[1]
        if recog.shape[1] < t:        # replicate the last step / crop
            recog = torch.cat([recog, recog[:, -1:].expand(
                -1, t - recog.shape[1], -1)], 1)
        recog = recog[:, :t]
        top_idx, classes, weights = select_columns(recog, self.max_chars)
        patches = gather_windows(strip, top_idx, self.window)
        char_styles = self.char_extractor(patches, classes)
        wsum = weights.sum(1, keepdim=True)
        avg = (char_styles * weights[..., None]).sum(1) / wsum.clamp_min(1e-8)
        avg = torch.where(wsum > 0, avg, torch.zeros_like(avg))

        xr = torch.cat([torch.relu(strip), recog.to(strip.dtype)], -1)
        xr = torch.relu(self.prep0(xr.transpose(1, 2)))
        xr = F.max_pool1d(xr, 2, 2)
        xr = self.prep1(xr)
        xr = torch.relu(self.GroupNorm_6(xr).to(xr.dtype))
        g = torch.relu(self.prep2(xr)).mean(2)             # (B, C)
        comb = torch.relu(self.final0(torch.cat([g.float(), avg], -1)))
        return self.final1(comb)
