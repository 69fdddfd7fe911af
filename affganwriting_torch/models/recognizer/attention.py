"""Bahdanau + location attention for the recognizer decoder.

Port of ``affganwriting_tpu/models/recognizer/attention.py``: the previous
attention distribution is convolved with ``filters`` filters of width
``kernel`` and projected into the additive-attention energy beside the
layer-averaged decoder state and the projected encoder outputs.  The
recognizer builds it with the default 128 filters, whatever
``config.attn_filters`` says, as the JAX package does.
"""

from __future__ import annotations

import torch
from torch import nn


class LocationAttention(nn.Module):
    def __init__(self, hidden: int = 512, filters: int = 128, kernel: int = 7):
        super().__init__()
        self.hidden_proj = nn.Linear(hidden, hidden)
        self.conv1d = nn.Conv1d(1, filters, kernel, padding=kernel // 2)
        self.prev_attn_proj = nn.Linear(filters, hidden)
        self.encoder_output_proj = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 1)

    def forward(self, hidden, enc_out, prev_attn):
        """hidden (L, B, H); enc_out (B, T, H); prev_attn (B, T) ->
        attention weights (B, T)."""
        h_att = self.hidden_proj(hidden.mean(dim=0))[:, None, :]
        conv = self.conv1d(prev_attn[:, None, :]).transpose(1, 2)  # (B, T, K)
        conv = self.prev_attn_proj(conv)
        enc_att = self.encoder_output_proj(enc_out)
        energy = self.out(torch.tanh(enc_att + h_att + conv))[..., 0]
        return torch.softmax(energy, dim=-1)
