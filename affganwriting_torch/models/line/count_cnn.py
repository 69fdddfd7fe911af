"""Spacing network of the line generator.

Port of ``affganwriting_tpu/models/line/count_cnn.py``: a 1-D convnet over
[label one-hot ++ broadcast style] predicting per character its (blank
count, duplicate count), denormalized by learned mean and std that start
at (2.0, 0.0) and (1.5, 0.5).  The GroupNorms keep flax's automatic names
(``GroupNorm_0``..``_2``) so that the flax tree converts as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from affganwriting_torch.models.blocks import GroupNorm, dropout
from affganwriting_torch.models.blocks import get_group_size


class CountCNN(nn.Module):
    def __init__(self, class_size: int = 80, style_size: int = 128,
                 hidden: int = 128, n_out: int = 2):
        super().__init__()
        self.spec = ((hidden, True), (hidden // 2, True), (hidden // 4, False))
        cin = class_size + style_size
        for i, (feats, _) in enumerate(self.spec):
            self.add_module(f"conv{i}", nn.Conv1d(cin, feats, 3, padding=1))
            self.add_module(f"GroupNorm_{i}",
                            GroupNorm(get_group_size(feats), feats))
            cin = feats
        self.head = nn.Conv1d(cin, n_out, 1)
        mean, std = (([2.0, 0.0], [1.5, 0.5]) if n_out == 2
                     else ([2.0] * n_out, [1.0] * n_out))
        self.mean = nn.Parameter(torch.tensor(mean))
        self.std = nn.Parameter(torch.tensor(std))

    def forward(self, label_onehot: torch.Tensor, style: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """label_onehot (B, T, class), style (B, style) -> (B, T, n_out);
        whole channels drop out (p 0.1) after the first two convs in train
        mode, masks from ``generator``."""
        b, t, _ = label_onehot.shape
        s = style[:, None, :].expand(b, t, style.shape[-1])
        x = torch.cat([label_onehot, s.to(label_onehot.dtype)], -1)
        x = x.transpose(1, 2)
        for i, (_, drop) in enumerate(self.spec):
            x = getattr(self, f"GroupNorm_{i}")(getattr(self, f"conv{i}")(x))
            if drop and self.training:
                x = dropout(x, 0.1, generator, channels=True)
            x = torch.relu(x)
        x = self.head(x).transpose(1, 2)
        return x * self.std + self.mean
