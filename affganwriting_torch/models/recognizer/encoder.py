"""Recognizer visual encoder: VGG19-BN trunk + 2-layer BiGRU (NCHW).

Port of ``affganwriting_tpu/models/recognizer/encoder.py``: cfg-'E' VGG19
with BatchNorm (4 max-pools: 64x216 -> 4x13x512), gray input repeated to 3
channels, the trunk flattened to a width-major sequence whose features are
ordered h-major (index h*C + c), and a bidirectional GRU whose two
directions are summed.  In train mode the trunk's BatchNorms use batch
statistics, whole (n, c) channels of the trunk output drop out
(``Dropout2d``), and so does the first GRU layer's output; masks come from
the ``generator`` passed in.  In eval mode the trunk with its flattening
and the BiGRU open the spans ``R.trunk`` and ``R.bigru``
(``utils/profiling.span``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import BatchNorm, Conv2d, dropout
from affganwriting_torch.utils.profiling import span

_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512)


class VGGTrunk(nn.Module):
    """cfg-'E' VGG19 with BatchNorm, 3-channel input, no classifier head."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin, ci = 3, 0
        for v in _VGG19_CFG:
            if v == "M":
                continue
            self.add_module(f"conv{ci}", Conv2d(cin, v, 3, padding=1,
                                                compute_dtype=dtype))
            self.add_module(f"bn{ci}", BatchNorm(v))
            cin, ci = v, ci + 1

    def forward(self, x):
        ci = 0
        for v in _VGG19_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv, bn = getattr(self, f"conv{ci}"), getattr(self, f"bn{ci}")
                x = torch.relu(bn(conv(x))).to(self.dtype)
                ci += 1
        return x


class BiGRU(nn.Module):
    """Bidirectional GRU layers ``gru0``, ``gru1``, outputs summed over
    directions, with dropout between the layers in train mode.

    Returns (outputs (B, T, H), dec_init_hidden (layers, B, H)): the
    decoder's initial state is the *backward* final state of each layer."""

    def __init__(self, input_size: int, hidden: int = 512, layers: int = 2,
                 dropout: float = 0.5):
        super().__init__()
        self.hidden, self.layers, self.dropout = hidden, layers, dropout
        for li in range(layers):
            self.add_module(f"gru{li}", nn.GRU(
                input_size if li == 0 else 2 * hidden, hidden,
                bidirectional=True, batch_first=True))

    def forward(self, x, generator: torch.Generator | None = None):
        with span("R.bigru", not self.training):
            finals = []
            for li in range(self.layers):
                x, h_n = getattr(self, f"gru{li}")(x)  # h_n (2, B, H) fwd/bwd
                finals.append(h_n[1])
                if self.training and li < self.layers - 1:
                    x = dropout(x, self.dropout, generator)
            out = x[..., :self.hidden] + x[..., self.hidden:]
            return out, torch.stack(finals)


class RecEncoder(nn.Module):
    """(B, 1 or 3, H, W) word image -> (enc_out (B, W/16, hidden), h0)."""

    def __init__(self, hidden: int = 512, img_height: int = 64,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.vgg = VGGTrunk(dtype)
        self.rnn = BiGRU((img_height // 16) * 512, hidden, dropout=dropout)

    def sequence(self, img, generator: torch.Generator | None = None):
        """The VGG trunk's features as the BiGRU's f32 input (B, W/16,
        (H/16) * 512)."""
        with span("R.trunk", not self.training):
            if img.shape[1] == 1:
                img = img.expand(-1, 3, -1, -1)
            return self.feat_sequence(self.vgg(img), generator)

    def feat_sequence(self, feat, generator: torch.Generator | None = None):
        """Trunk features (B, 512, H/16, W/16) -> the BiGRU's f32 input;
        whole channels drop out in train mode."""
        if self.training:
            feat = dropout(feat, self.dropout, generator, channels=True)
        b, c, h, w = feat.shape
        # width is the sequence axis; features flatten (height, channel)
        return feat.permute(0, 3, 2, 1).reshape(b, w, h * c).float()

    def from_feat(self, feat, generator: torch.Generator | None = None):
        """The tail after the trunk (JAX ``RecEncoder.from_feat``): trunk
        features, e.g. the int8 trunk's (``ops/quant.py:vgg_quant_apply``)
        -> (enc_out, the decoder's initial hidden state)."""
        return self.rnn(self.feat_sequence(feat, generator), generator)

    def forward(self, img, generator: torch.Generator | None = None):
        return self.rnn(self.sequence(img, generator), generator)
