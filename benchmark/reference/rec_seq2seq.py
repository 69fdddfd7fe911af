"""The reference's seq2seq R (GAN_word's recognizer): the VGG19-BN trunk,
a two-layer BiGRU and the location-attention decoder, greedy over
``max_chars + 1`` steps; and its tap on the program's R, which has the
same modules under the same names."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import BatchNorm, Conv, Dense, dropout

VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512)


class VGGTrunk(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for v in VGG19:
            if v != "M":
                self.add_module(f"conv{i}", Conv(cin, v, 3, 1, 1))
                self.add_module(f"bn{i}", BatchNorm(v))
                cin, i = v, i + 1

    def forward(self, x):
        i = 0
        for v in VGG19:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(getattr(self, f"bn{i}")(
                    getattr(self, f"conv{i}")(x)))
                i += 1
        return x


class BiGRU(nn.Module):
    def __init__(self, din, hidden=512, layers=2, p=0.5):
        super().__init__()
        self.hidden, self.layers, self.p = hidden, layers, p
        for li in range(layers):
            self.add_module(f"gru{li}", nn.GRU(
                din if li == 0 else 2 * hidden, hidden, bidirectional=True,
                batch_first=True))

    def forward(self, x, gen=None):
        finals = []
        for li in range(self.layers):
            x, h_n = getattr(self, f"gru{li}")(x)
            finals.append(h_n[1])
            if self.training and li < self.layers - 1:
                x = dropout(x, self.p, gen)
        return x[..., :self.hidden] + x[..., self.hidden:], torch.stack(finals)


class RecEncoder(nn.Module):
    def __init__(self, hidden, img_h, p):
        super().__init__()
        self.p = p
        self.vgg = VGGTrunk()
        self.rnn = BiGRU((img_h // 16) * 512, hidden, p=p)

    def forward(self, img, gen=None):
        feat = self.vgg(img.expand(-1, 3, -1, -1) if img.shape[1] == 1 else img)
        if self.training:
            feat = dropout(feat, self.p, gen, channels=True)
        b, c, h, w = feat.shape
        return self.rnn(feat.permute(0, 3, 2, 1).reshape(b, w, h * c), gen)


class LocationAttention(nn.Module):
    def __init__(self, hidden=512, filters=128, kernel=7):
        super().__init__()
        self.hidden_proj = Dense(hidden, hidden)
        self.conv1d = nn.Conv1d(1, filters, kernel, padding=kernel // 2)
        self.prev_attn_proj = Dense(filters, hidden)
        self.encoder_output_proj = Dense(hidden, hidden)
        self.out = Dense(hidden, 1)

    def forward(self, hidden, enc_out, prev_attn):
        h_att = self.hidden_proj(hidden.mean(dim=0))[:, None, :]
        conv = self.prev_attn_proj(
            self.conv1d(prev_attn[:, None, :]).transpose(1, 2))
        energy = self.out(torch.tanh(self.encoder_output_proj(enc_out)
                                     + h_att + conv))[..., 0]
        return torch.softmax(energy, dim=-1)


class DecoderCell(nn.Module):
    def __init__(self, vocab, hidden, embed, p):
        super().__init__()
        self.p = p
        self.attention = LocationAttention(hidden)
        self.embedding = nn.Embedding(vocab, embed)
        self.gru0 = nn.GRUCell(embed + hidden, hidden)
        self.gru1 = nn.GRUCell(hidden, hidden)
        self.out = Dense(hidden, vocab)

    def forward(self, hidden, prev_attn, prev_id, enc_out, gen=None):
        attn = self.attention(hidden, enc_out, prev_attn)
        context = torch.einsum("bt,bth->bh", attn, enc_out)
        h0 = self.gru0(torch.cat([self.embedding(prev_id), context], -1),
                       hidden[0])
        x = dropout(h0, self.p, gen) if self.training else h0
        h1 = self.gru1(x, hidden[1])
        return torch.stack([h0, h1]), attn, self.out(h1)


def _keep_n_gate(hidden):
    def hook(grad):
        return torch.cat([grad.new_zeros(2 * hidden), grad[2 * hidden:]])
    return hook


class Recognizer(nn.Module):
    """VGG-BiGRU encoder and the attention decoder.  ``feed`` (B, steps)
    gives the token each step reads after GO: the program's own greedy
    ids, so the reference follows the path the program took; without it
    the reference decodes greedily on its own."""

    def __init__(self, cfg: dict, p=0.5):
        super().__init__()
        h = cfg["rec_hidden"]
        self.steps = cfg["max_chars"] + 1
        self.enc = RecEncoder(h, cfg["img_height"], p)
        self.dec = DecoderCell(55, h, cfg["rec_embed"], p)
        self.gate_hooks()

    def gate_hooks(self):
        """Hold the GRUs' recurrent r and z biases, which flax's GRU cell
        lacks, at their value: their gradient is zeroed.  Call again after
        the parameters are replaced (``to_empty``)."""
        for name, prm in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias_hh"):
                prm.register_hook(_keep_n_gate(self.dec.gru0.hidden_size))

    def forward(self, img, labels, gen=None, feed=None):
        enc_out, hidden = self.enc(img, gen)
        attn = enc_out.new_zeros(enc_out.shape[:2])
        prev = labels[:, 0]
        logits = []
        for t in range(self.steps):
            hidden, attn, lg = self.dec(hidden, attn, prev, enc_out, gen)
            prev = lg.argmax(-1) if feed is None else feed[:, t]
            logits.append(lg)
        return torch.stack(logits, dim=1)


def build(cfg: dict, p: float = 0.5) -> nn.Module:
    return Recognizer(cfg, p)


class Tap:
    """R's per-step logits as the program computed them, read by a forward
    hook on the decoder cell's output layer ``dec.out``, one call a step.
    The hook sits below ``forward`` because the w8a8 path reads through
    ``read_features`` after its int8 trunk and never calls ``forward``.
    The ids R fed itself are the logits' argmax, as its greedy loop feeds.

    ``take()`` hands over what was read since the last take as a function
    that returns R's calls, each (logits (B, T - 1, V), ids (B, T - 1));
    the stacking runs only when that function is called, so that a take
    inside a timed window launches nothing on the device."""

    def __init__(self, rec: nn.Module, cfg: dict):
        self.steps, self.read = cfg["max_chars"] + 1, []
        self.handle = rec.dec.out.register_forward_hook(
            lambda m, a, out: self.read.append(out.detach()))

    def take(self):
        read, steps = self.read, self.steps
        self.read = []

        def calls():
            out = []
            for i in range(0, len(read), steps):
                logits = torch.stack(read[i:i + steps], 1)
                out.append((logits, logits.argmax(-1)))
            return out
        return calls

    def remove(self) -> None:
        self.handle.remove()
