"""Text encoder: char embeddings -> AdaIN params + spatial content map.

Port of ``affganwriting_tpu/models/text_encoder.py``.  The FC pyramid
(T*E -> 1024 -> 2048 -> adain_dim, BatchNorm + ReLU after the first two)
gives the AdaIN (mean, std) parameters; a per-char projection is tiled across
the style-feature grid: each of the T chars occupies ``w // T`` columns, the
remaining ``w % T`` columns carry the PAD-char projection, and rows are
broadcast over the height.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.models.blocks import BatchNorm, Linear


class TextEncoderFC(nn.Module):
    """labels (B, T) -> (adain_params (B, adain_dim),
    content map (B, content_dim, h, w))."""

    def __init__(self, max_len: int = 12, vocab_size: int = VOCAB.size,
                 embed_dim: int = 64, content_dim: int = 512,
                 adain_dim: int = 4096, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.fc0 = Linear(max_len * embed_dim, 1024, compute_dtype=dtype)
        self.BatchNorm_0 = BatchNorm(1024)
        self.fc1 = Linear(1024, 2048, compute_dtype=dtype)
        self.BatchNorm_1 = BatchNorm(2048)
        self.fc2 = Linear(2048, adain_dim, compute_dtype=dtype)
        self.linear = Linear(embed_dim, content_dim, compute_dtype=dtype)

    def _embed(self, ids):
        return F.embedding(ids, self.embed.weight).to(self.dtype)

    def forward(self, labels: torch.Tensor, feat_hw: tuple[int, int]):
        b, t = labels.shape
        h, w = feat_hw
        xx = self._embed(labels)                            # (B, T, E)

        out = xx.reshape(b, -1)
        out = torch.relu(self.BatchNorm_0(self.fc0(out))).to(self.dtype)
        out = torch.relu(self.BatchNorm_1(self.fc1(out))).to(self.dtype)
        out = self.fc2(out)

        xx_new = self.linear(xx)                            # (B, T, C)
        body = xx_new.repeat_interleave(max(1, w // t), dim=1)
        pad_cols = w - body.shape[1]
        if pad_cols > 0:
            pad_ids = torch.full((1, 1), VOCAB.pad, dtype=labels.dtype,
                                 device=labels.device)
            pad_vec = self.linear(self._embed(pad_ids))     # (1, 1, C)
            body = torch.cat(
                [body, pad_vec.expand(b, pad_cols, -1).to(body.dtype)], dim=1)
        else:
            body = body[:, :w]
        content = body.transpose(1, 2)[:, :, None, :].expand(-1, -1, h, -1)
        return out, content
