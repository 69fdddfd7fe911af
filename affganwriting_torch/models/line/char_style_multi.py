"""Multi-style character encoder (the ``char_style_dim > 0`` path).

Port of ``affganwriting_tpu/models/line/char_style_multi.py``: a
``CharStyleEncoder`` trunk (``trunk``) gives the global and spacing
styles; per found character class a private style is the score-weighted
average of its columns' styles (a bank over windows of the recognition
log-probs), a per-class ``fill_pred`` net predicts every class's style
from each found one, the predictions are averaged over the found classes
and mixed with the found classes' own styles.  Returns ``(g_style,
spacing_style, char_style (B, n_class, char_style_dim))``.  Columns are
taken with ``lax.top_k``'s tie order (``char_style.top_columns``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.line.char_style import (
    CharExtractorBank,
    CharStyleEncoder,
    gather_windows,
    select_columns,
)


class MultiCharStyleEncoder(nn.Module):
    def __init__(self, n_class: int = 80, dim: int = 64,
                 style_dim: int = 128, char_style_dim: int = 32,
                 char_dim: int = 64, window: int = 2, max_chars: int = 32,
                 average_found_char_style: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, d = n_class, char_style_dim
        self.n_class, self.d = k, d
        self.window, self.max_chars = window, max_chars
        self.lam = average_found_char_style
        self.trunk = CharStyleEncoder(k, dim, style_dim + d, char_dim, window,
                                      max_chars, dtype)
        self.char_extractor = CharExtractorBank(k, k, char_dim, d)
        self.fill_w1 = nn.Parameter(torch.zeros(k, d, 2 * d))
        self.fill_b1 = nn.Parameter(torch.zeros(k, 2 * d))
        self.fill_w2 = nn.Parameter(torch.zeros(k, 2 * d, k * d))
        self.fill_b2 = nn.Parameter(torch.zeros(k, k * d))

    def forward(self, image, recog):
        k, d = self.n_class, self.d
        comb = self.trunk(image, recog)
        spacing_style, g_style = comb[:, :d], comb[:, d:]

        b = image.shape[0]
        top_idx, classes, weights = select_columns(recog, self.max_chars)
        patches = gather_windows(recog.float(), top_idx, self.window)
        col_styles = self.char_extractor(patches, classes)
        onehot = F.one_hot(classes, k).float() * weights[..., None]
        per_class_sum = torch.einsum("bnk,bnd->bkd", onehot, col_styles)
        per_class_w = onehot.sum(1)                               # (B, K)
        found = per_class_sum / per_class_w[..., None].clamp_min(1e-8)
        found_mask = (per_class_w > 0).float()

        h = torch.relu(torch.einsum("bkd,kde->bke", found, self.fill_w1)
                       + self.fill_b1)
        fill = (torch.einsum("bke,kef->bkf", h, self.fill_w2)
                + self.fill_b2).reshape(b, k, k, d)               # src, dst
        denom = found_mask.sum(1).clamp_min(1.0)
        all_char = torch.einsum("bk,bkjd->bjd", found_mask, fill) \
            / denom[:, None, None]
        mixed = found * (1 - self.lam) + all_char * self.lam
        char_style = torch.where(found_mask[..., None] > 0, mixed, all_char)
        return g_style, spacing_style, char_style


def space_style(spaced, styles, blank_style):
    """Per-position styles along the spaced line: a character position
    takes its class's style, a blank the spacing style.  spaced (B, L, K)
    one-hot, styles (B, K, D), blank_style (B, D) -> (B, L, D)."""
    classes = spaced.argmax(-1)
    per_pos = styles.gather(1, classes[..., None].expand(
        -1, -1, styles.shape[-1]))
    return torch.where((classes == 0)[..., None], blank_style[:, None, :],
                       per_pos)
