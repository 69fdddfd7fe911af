"""HWWithStyle, the line-generation model container (forward).

Port of ``affganwriting_tpu/models/line/container.py``: a frozen line HWR
(``hwr_type``), the character-aware style extractor (single style, or the
multi-style encoder when ``char_style_dim > 0``, whose three parts travel
packed as one (B, style_dim + char_style_dim * (1 + n_class)) array), the
``CountCNN`` spacer, ``insert_spaces`` and the ``SpacedGenerator``.
Images are (B, 1, H, W); labels (B, T) class ids; spaced lines (B, L,
n_class) one-hot at the static length ``max_gen_length``.

Randomness comes from one ``torch.Generator`` (the JAX package's
``"dropout"``, ``"spacing"`` and ``"noise"`` rngs): the spacer's dropout
masks in train mode, the spacing noise, then the generator's, or from
tensors the caller hands in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.line.char_style import CharStyleEncoder
from affganwriting_torch.models.line.char_style_multi import (
    MultiCharStyleEncoder,
    space_style,
)
from affganwriting_torch.models.line.count_cnn import CountCNN
from affganwriting_torch.models.line.hwr import CNNOnlyHWR, CRNN, SmallCRNN
from affganwriting_torch.models.line.spaced_gen import SpacedGenerator
from affganwriting_torch.parallel.ops import batch_random


def insert_spaces(label, label_lengths, counts, n_class: int, max_len: int,
                  count_std: float = 1e-8, dup_std: float = 1e-9, *,
                  generator: torch.Generator | None = None, noise=None):
    """Sampled spacing -> (spaced one-hot (B, max_len, n_class), padded
    fraction (B,)).  Each character t gets round(blank count + count_std *
    n1) blanks, then round(dup count + dup_std * n2) copies of itself
    (both at least 0; none past ``label_lengths``), laid out by interval
    arithmetic; positions past ``max_len`` are dropped.  ``noise``: (n1,
    n2), each (B, T), else drawn from ``generator``."""
    b, t = label.shape
    if noise is None:
        noise = tuple(batch_random(torch.randn, (b, t), generator,
                                   counts.device) for _ in range(2))
    blanks = torch.round(counts[..., 0] + count_std * noise[0]).clamp_min(0)
    dups = torch.round(counts[..., 1] + dup_std * noise[1]).clamp_min(0)
    valid = torch.arange(t, device=label.device)[None, :] \
        < label_lengths[:, None]
    blanks = torch.where(valid, blanks, torch.zeros_like(blanks))
    dups = torch.where(valid, dups, torch.zeros_like(dups))

    run = blanks + dups
    start = torch.cumsum(run, 1) - run
    char_start = start + blanks
    char_end = char_start + dups
    pos = torch.arange(max_len, dtype=torch.float32,
                       device=counts.device)[None, :, None]
    in_char = ((pos >= char_start[:, None, :]) & (pos < char_end[:, None, :])
               & valid[:, None, :])
    onehot = F.one_hot(label.long(), n_class).float()
    spaced = torch.einsum("blt,btk->blk", in_char.float(), onehot)
    is_blank = (spaced.sum(-1) < 0.5).float()
    spaced = torch.cat([is_blank[..., None], spaced[..., 1:]], -1)
    padded = ((max_len - run.sum(1)) / max_len).clamp(0.0, 1.0)
    return spaced, padded


class HWWithStyle(nn.Module):
    def __init__(self, n_class: int = 80, style_dim: int = 128,
                 gen_dim: int = 256, hwr_type: str = "cnn_only",
                 hwr_norm: str = "batch", max_gen_length: int = 500,
                 count_std: float = 1e-8, dup_std: float = 1e-9,
                 char_style_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_class, self.style_dim = n_class, style_dim
        self.max_gen_length = max_gen_length
        self.count_std, self.dup_std = count_std, dup_std
        self.char_style_dim = char_style_dim
        hwr = {"crnn": CRNN, "small_crnn": SmallCRNN}.get(hwr_type,
                                                          CNNOnlyHWR)
        self.hwr = hwr(n_class, norm=hwr_norm, dtype=dtype)
        if char_style_dim > 0:
            self.style_extractor = MultiCharStyleEncoder(
                n_class=n_class, style_dim=style_dim,
                char_style_dim=char_style_dim, dtype=dtype)
        else:
            self.style_extractor = CharStyleEncoder(
                n_class=n_class, style_dim=style_dim, dtype=dtype)
        self.spacer = CountCNN(n_class, style_dim)
        self.generator = SpacedGenerator(n_class, style_dim, gen_dim,
                                         char_style_dim=char_style_dim,
                                         dtype=dtype)

    def _pack_style(self, g, spacing, char):
        return torch.cat([g, spacing, char.reshape(g.shape[0], -1)], -1)

    def _unpack_style(self, style):
        d, s = self.char_style_dim, self.style_dim
        return (style[:, :s], style[:, s:s + d],
                style[:, s + d:].reshape(style.shape[0], self.n_class, d))

    def recognize(self, image):
        return self.hwr(image)

    def extract_style(self, image, a_batch_size: int = 1):
        """(style, the HWR's log-probs) of image (B, 1, H, W).  The HWR
        reads in eval mode whatever the container's mode (the JAX
        package's frozen HWR).  With ``a_batch_size`` > 1, each author's
        ``a_batch_size`` consecutive lines are joined width-wise (their
        log-probs along time) before extraction, and the style repeats for
        each of them."""
        was = self.hwr.training
        self.hwr.eval()
        try:
            pred = self.hwr(image)
        finally:
            self.hwr.train(was)
        b, c, h, w = image.shape
        a = a_batch_size
        if a > 1:
            image = image.reshape(b // a, a, c, h, w)
            image = torch.cat([image[:, i] for i in range(a)], dim=3)
            p = pred.reshape(b // a, a, *pred.shape[1:])
            recog = torch.cat([p[:, i] for i in range(a)], dim=1)
        else:
            recog = pred
        style = self.style_extractor(image, recog)
        if self.char_style_dim > 0:
            style = self._pack_style(*style)
        return (style.repeat_interleave(a, dim=0) if a > 1 else style), pred

    def space(self, label, label_lengths, style, *,
              generator: torch.Generator | None = None, noise=None):
        """(spaced, the spacer's counts, padded fraction); ``noise`` is
        ``insert_spaces``'.  The spacer draws its dropout masks (train mode)
        from ``generator`` before the spacing noise."""
        onehot = F.one_hot(label.long(), self.n_class).float()
        g = style if self.char_style_dim == 0 else self._unpack_style(style)[0]
        counts = self.spacer(onehot, g, generator)
        spaced, padded = insert_spaces(
            label, label_lengths, counts, self.n_class, self.max_gen_length,
            self.count_std, self.dup_std, generator=generator, noise=noise)
        return spaced, counts, padded

    def forward(self, label, label_lengths, style, spaced=None, *,
                generator: torch.Generator | None = None, noise=None):
        """label (B, T) -> (line (B, 1, 64, 4 * max_gen_length), spaced,
        counts or None when ``spaced`` is given).  ``noise``: the
        generator's ten tensors (``SpacedGenerator``)."""
        counts = None
        if spaced is None:
            spaced, counts, _ = self.space(label, label_lengths, style,
                                           generator=generator)
        if self.char_style_dim > 0:
            g, spacing, char = self._unpack_style(style)
            img = self.generator(spaced, g, space_style(spaced, char, spacing),
                                 generator=generator, noise=noise)
        else:
            img = self.generator(spaced, style, generator=generator,
                                 noise=noise)
        return img, spaced, counts

    def generate(self, label, label_lengths, style, *,
                 generator: torch.Generator | None = None):
        return self(label, label_lengths, style, generator=generator)[0]
