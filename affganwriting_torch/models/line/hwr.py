"""Line-level CTC handwriting recognizers (NCHW).

Port of ``affganwriting_tpu/models/line/hwr.py``: ``CRNN`` (a 7-conv trunk
and a BiLSTM), ``SmallCRNN`` (the h=24 variant) and ``CNNOnlyHWR`` (the
trunk and dilated 1-D convs, the active config's frozen recognizer).  A
(B, 1, H, W) line -> per-step log-probabilities (B, T, nclass), T ~ W/4;
class 0 is the CTC blank.  Norms follow ``norm``: BatchNorm (running
statistics in eval mode) or GroupNorm.

flax's ``OptimizedLSTMCell`` has no input-side bias: its i/f/g/o input
kernels map to ``nn.LSTM``'s ``weight_ih`` and its hidden kernels and
biases to ``weight_hh`` and ``bias_hh``, with ``bias_ih`` held at 0 (a
gradient hook keeps a trainer from moving it, as the recognizer's GRU
keeps its r and z recurrent biases).  The two directions are flax's
``OptimizedLSTMCell_0`` (forward) and ``_1`` (backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.models.blocks import (
    BatchNorm,
    Conv1d,
    Conv2d,
    GroupNorm,
    dropout,
    get_group_size,
)

_PAD = (1, 1, 1, 1, 1, 0, 0)
_NM = (64, 128, 256, 256, 512, 512, 512)
_NORMED = (2, 4, 6)   # convs followed by a norm


def line_norm(kind: str, channels: int) -> nn.Module:
    """GroupNorm for ``"group"``, else BatchNorm (flax's, eps 1e-5)."""
    if kind == "group":
        return GroupNorm(get_group_size(channels), channels)
    return BatchNorm(channels)


def to_sequence(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, W, C): the height-1 row, or the mean over H."""
    seq = x[:, :, 0] if x.shape[2] == 1 else x.mean(2)
    return seq.transpose(1, 2)


def _pool_w1(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride (2, 1), width padded by 1 with -inf."""
    return F.max_pool2d(x, (2, 2), stride=(2, 1), padding=(0, 1))


def _zero_bias_ih(lstm: nn.LSTM) -> None:
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            if name.startswith("bias_ih"):
                p.zero_()
                p.register_hook(torch.zeros_like)


class ConvTrunk(nn.Module):
    """The shared 7-conv trunk: (B, 1, 64, W) -> (B, T, 512)."""

    def __init__(self, norm: str = "group", small: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.small = small
        cin = 1
        for i in range(7):
            self.add_module(f"conv{i}", Conv2d(cin, _NM[i], 3,
                                               padding=_PAD[i],
                                               compute_dtype=dtype))
            if i in _NORMED:
                self.add_module(f"norm{i}", line_norm(norm, _NM[i]))
            cin = _NM[i]

    def forward(self, x):
        for i in range(7):
            x = getattr(self, f"conv{i}")(x)
            if i in _NORMED:
                x = getattr(self, f"norm{i}")(x).to(x.dtype)
            x = torch.relu(x)
            if (i == 0 and not self.small) or i == 1:
                x = F.max_pool2d(x, 2, 2)
            elif i in (3, 5):
                x = _pool_w1(x)
        return to_sequence(x)


class _BiLSTMHead(nn.Module):
    """BiLSTM over the f32 sequence, a dense to the classes, log-softmax."""

    def _init_head(self, nclass: int, hidden: int, use_softmax: bool):
        self.use_softmax = use_softmax
        self.lstm = nn.LSTM(512, hidden, bidirectional=True,
                            batch_first=True)
        _zero_bias_ih(self.lstm)
        self.embedding = nn.Linear(2 * hidden, nclass)

    def _head(self, seq):
        h, _ = self.lstm(seq.float())
        logits = self.embedding(h)
        return torch.log_softmax(logits, -1) if self.use_softmax else logits


class CRNN(_BiLSTMHead):
    """Conv trunk + one BiLSTM layer + class head."""

    def __init__(self, nclass: int = 80, hidden: int = 512,
                 norm: str = "batch", use_softmax: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = ConvTrunk(norm, dtype=dtype)
        self._init_head(nclass, hidden, use_softmax)

    def forward(self, x):
        return self._head(self.cnn(x))


class SmallCRNN(_BiLSTMHead):
    """The h=24 variant: 128 channels from conv0, pools after convs 1, 3
    and 5, a final VALID conv collapsing height 3 -> 1, whole-channel
    dropout 0.1 after convs 2-6 in train mode (masks from ``generator``),
    inputs width-padded with zeros to at least 12.  T = W/4 - 2."""

    _NM = (128, 128, 256, 256, 512, 512, 512)
    _PADS = (1, 1, 1, 1, 1, 1, 0)
    _NORMED = (1, 2, 4, 6)
    _DROPPED = (2, 3, 4, 5, 6)

    def __init__(self, nclass: int = 80, hidden: int = 512,
                 norm: str = "batch", use_softmax: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 1
        for i, c in enumerate(self._NM):
            self.add_module(f"conv{i}", Conv2d(cin, c, 3,
                                               padding=self._PADS[i],
                                               compute_dtype=dtype))
            if i in self._NORMED:
                self.add_module(f"norm{i}", line_norm(norm, c))
            cin = c
        self._init_head(nclass, hidden, use_softmax)

    def forward(self, x, generator: torch.Generator | None = None):
        if x.shape[3] < 12:
            diff = 12 - x.shape[3]
            x = F.pad(x, (diff // 2, diff - diff // 2))
        for i in range(7):
            x = getattr(self, f"conv{i}")(x)
            if i in self._NORMED:
                x = getattr(self, f"norm{i}")(x).to(x.dtype)
            if i in self._DROPPED and self.training:
                x = dropout(x, 0.1, generator, channels=True)
            x = torch.relu(x)
            if i in (1, 3):
                x = F.max_pool2d(x, 2, 2)
            elif i == 5:
                x = _pool_w1(x)
        return self._head(to_sequence(x))


class CNNOnlyHWR(nn.Module):
    """Conv trunk + four dilated 1-D convs (the active config's frozen
    recognizer, 'CNNOnly batchnorm')."""

    _SPEC = ((512, 2, 2), (512, 4, 4), (512, 1, 0), (512, 8, 8))

    def __init__(self, nclass: int = 80, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = ConvTrunk(norm, dtype=dtype)
        for i, (feats, dil, pad) in enumerate(self._SPEC):
            self.add_module(f"c1d_{i}", Conv1d(512, feats, 3, padding=pad,
                                               dilation=dil,
                                               compute_dtype=dtype))
            self.add_module(f"n1d_{i}", line_norm(norm, feats))
        self.c1d_out = Conv1d(512, nclass, 3, compute_dtype=dtype)

    def forward(self, x):
        seq = self.cnn(x).transpose(1, 2)                 # (B, C, T)
        for i in range(len(self._SPEC)):
            seq = getattr(self, f"c1d_{i}")(seq)
            seq = torch.relu(getattr(self, f"n1d_{i}")(seq).to(seq.dtype))
        logits = self.c1d_out(seq).float()
        return torch.log_softmax(logits, 1).transpose(1, 2)
