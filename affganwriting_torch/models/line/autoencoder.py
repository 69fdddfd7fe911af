"""Perceptual autoencoder of the line GAN and its E_HWR head (NCHW).

Port of ``affganwriting_tpu/models/line/autoencoder.py`` (the reference's
line_generation/model/autoencoder.py:8-769).  The GAN trainer uses the
'2tight' variant (a 32-channel bottleneck): its encoder features are the
perceptual loss, the L1 of the feature pairs of real and reconstruction
(hw_with_style_trainer.py:735-758).  ``VARIANTS`` gives the width
multiplier and bottleneck of the reference's other sizes.

``hwr_classes`` adds the E_HWR head (autoencoder.py:596-629, the newCTC
recipe): dilated 1-D convs over the height-mean of the bottleneck,
emitting CTC log-probs (B, W', n_class).  The GroupNorms keep flax's
automatic names (``GroupNorm_0``..``_7``; the head's ``GroupNorm_0``..``_3``
inside ``e_hwr``), so the flax tree converts as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import (
    Conv1d,
    Conv2d,
    GroupNorm,
    dropout,
    get_group_size,
)

# variant -> (width multiplier, bottleneck channels)
VARIANTS: dict[str, tuple[float, int]] = {
    "2": (1.0, 256),
    "2tight": (1.0, 32),
    "2tighter": (1.0, 16),
    "small": (0.5, 128),
    "32": (1.0, 256),
}

_EHWR = ((3, 1), (3, 2), (3, 4), (5, 1))      # (kernel, dilation)


class EHWRHead(nn.Module):
    """conv1d(3, d 1) -> conv1d(3, d 2) -> conv1d(3, d 4) -> conv1d(5) ->
    1x1 to classes, GroupNorm, dropout and ReLU between, log-softmax out;
    (B, W, C) -> (B, W, n_class)."""

    def __init__(self, cin: int, n_class: int, width: int = 512,
                 p: float = 0.1):
        super().__init__()
        self.p = p
        for i, (k, d) in enumerate(_EHWR):
            pad = (k - 1) // 2 * d if k == 3 else 2
            self.add_module(f"conv{i}", Conv1d(cin, width, k, padding=pad,
                                               dilation=d))
            self.add_module(f"GroupNorm_{i}",
                            GroupNorm(get_group_size(width), width))
            cin = width
        self.out = Conv1d(width, n_class, 1)

    def forward(self, strip: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = strip.transpose(1, 2)
        for i in range(len(_EHWR)):
            h = getattr(self, f"GroupNorm_{i}")(getattr(self, f"conv{i}")(h))
            if self.training:
                h = dropout(h, self.p, generator)
            h = torch.relu(h)
        return F.log_softmax(self.out(h).float(), dim=1).transpose(1, 2)


class Autoencoder(nn.Module):
    def __init__(self, variant: str = "2tight", dim: int = 64,
                 out_dim: int = 1, hwr_classes: int | None = None):
        super().__init__()
        mul, self.bottleneck = VARIANTS[variant]
        d = int(dim * mul)
        self.widths = (d, 2 * d, 4 * d, 4 * d)
        cin = 1
        for i, feat in enumerate(self.widths):
            self.add_module(f"enc{i}", Conv2d(cin, feat, 4, stride=2,
                                              padding=1))
            self.add_module(f"GroupNorm_{i}",
                            GroupNorm(get_group_size(feat), feat))
            cin = feat
        self.to_z = Conv2d(cin, self.bottleneck, 3, padding=1)
        self.e_hwr = (None if hwr_classes is None
                      else EHWRHead(self.bottleneck, hwr_classes))
        cin = self.bottleneck
        for i, feat in enumerate(reversed(self.widths)):
            self.add_module(f"dec{i}", Conv2d(cin, feat, 3, padding=1))
            self.add_module(f"GroupNorm_{len(self.widths) + i}",
                            GroupNorm(get_group_size(feat), feat))
            cin = feat
        self.head = Conv2d(cin, out_dim, 5, padding=2)

    def encode(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The four encoder stages' outputs and the bottleneck z."""
        feats, h = [], x
        for i in range(len(self.widths)):
            h = torch.relu(getattr(self, f"GroupNorm_{i}")(
                getattr(self, f"enc{i}")(h)))
            feats.append(h)
        feats.append(self.to_z(h))
        return feats

    def forward(self, x: torch.Tensor, *, return_features: bool = False,
                return_ctc: bool = False,
                generator: torch.Generator | None = None):
        """x (B, 1, H, W) -> tanh reconstruction; the feature list with
        ``return_features``; (reconstruction, CTC log-probs or None) with
        ``return_ctc``."""
        feats = self.encode(x)
        if return_features:
            return feats
        z = feats[-1]
        ctc = None if self.e_hwr is None else self.e_hwr(
            z.mean(2).transpose(1, 2), generator)
        h, n = z, len(self.widths)
        for i in range(n):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = torch.relu(getattr(self, f"GroupNorm_{n + i}")(
                getattr(self, f"dec{i}")(h)))
        recon = torch.tanh(self.head(h))
        return (recon, ctc) if return_ctc else recon
