"""Attention seq2seq recognizer R: greedy decoding with optional teacher
forcing, and batched beam search.

Port of ``affganwriting_tpu/models/recognizer/seq2seq.py`` (``DecoderCell``,
``Recognizer.__call__``/``decode`` and ``beam_search``): the JAX
``nn.scan`` over ``output_max_len - 1`` steps is a Python loop here.
Teacher forcing (the standalone HTR trainer's) feeds step t + 1 the label
``labels[:, t + 1]`` where a (steps, B) mask is set, else step t's argmax;
the mask is ``uniform < teacher_rate`` drawn from a ``torch.Generator``
(the JAX package draws ``jax.random.uniform(key, (steps, B)) < rate``), or
handed in whole.  The GAN step free-runs (no mask, nothing drawn).  The
decoder runs in f32 whatever the trunk's compute dtype, as in the JAX
package.  In train mode (the GAN step's free-running decoding) the first
GRU layer's output drops out before the second, with a fresh mask each
step, and the encoder's dropouts and batch statistics apply; masks come
from the ``generator`` passed in.  The greedy feedback is an ``argmax``,
which carries no gradient, in the JAX package as here.
"""

from __future__ import annotations

import torch
from torch import nn

from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.models.blocks import dropout
from affganwriting_torch.models.recognizer.attention import LocationAttention
from affganwriting_torch.models.recognizer.encoder import RecEncoder
from affganwriting_torch.parallel.ops import batch_random
from affganwriting_torch.utils.profiling import span


class DecoderCell(nn.Module):
    """One decode step: attention -> context -> 2-layer GRU -> logits."""

    def __init__(self, vocab_size: int = VOCAB.size, hidden: int = 512,
                 embed_dim: int = 60, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.attention = LocationAttention(hidden)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.gru0 = nn.GRUCell(embed_dim + hidden, hidden)
        self.gru1 = nn.GRUCell(hidden, hidden)
        self.out = nn.Linear(hidden, vocab_size)

    def forward(self, hidden, prev_attn, prev_id, enc_out,
                generator: torch.Generator | None = None):
        """hidden (2, B, H), prev_attn (B, T), prev_id (B,), enc_out
        (B, T, H) -> (new hidden, attn, logits (B, V))."""
        attn = self.attention(hidden, enc_out, prev_attn)
        context = torch.einsum("bt,bth->bh", attn, enc_out)
        x = torch.cat([self.embedding(prev_id), context], dim=-1)
        h0 = self.gru0(x, hidden[0])
        x = dropout(h0, self.dropout, generator) if self.training else h0
        h1 = self.gru1(x, hidden[1])
        return torch.stack([h0, h1]), attn, self.out(h1)


def _keep_n_gate(hidden: int):
    """Gradient hook of a GRU's ``bias_hh`` ([r, z, n] x hidden): zero on
    the r and z thirds."""
    def hook(grad):
        return torch.cat([grad.new_zeros(2 * hidden), grad[2 * hidden:]])
    return hook


class Recognizer(nn.Module):
    """VGG-BiGRU encoder + greedy attention decoder.  ``forward(img,
    labels)`` returns per-step logits (B, T_out - 1, V) and attention
    weights (B, T_out - 1, W/16); free running reads only ``labels[:, 0]``
    (GO), teacher forcing ``labels[:, 1:]`` where its mask is set."""

    def __init__(self, vocab_size: int = VOCAB.size, hidden: int = 512,
                 embed_dim: int = 60, output_max_len: int = 12,
                 img_height: int = 64, dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.5):
        super().__init__()
        self.output_max_len = output_max_len
        self.enc = RecEncoder(hidden, img_height, dtype, dropout)
        self.dec = DecoderCell(vocab_size, hidden, embed_dim, dropout)
        # flax's GRU cell has no recurrent bias on its r and z gates; torch
        # carries one beside the input bias, which training would move as
        # well (twice the step on those gates), so it is held at 0
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias_hh"):
                p.register_hook(_keep_n_gate(hidden))

    def forward(self, img, labels, generator: torch.Generator | None = None,
                *, teacher_rate: float = 0.0,
                teacher_mask: torch.Tensor | None = None):
        enc_out, hidden0 = self.enc(img, generator)
        return self.decode(enc_out, hidden0, labels, generator,
                           teacher_rate=teacher_rate,
                           teacher_mask=teacher_mask)

    def read_features(self, feat, labels):
        """Free-running logits and attention from trunk features (B, 512,
        H/16, W/16) computed elsewhere: the int8 serving path's tail
        (JAX ``Recognizer.read_features``).  Call it in eval mode."""
        enc_out, hidden0 = self.enc.from_feat(feat)
        return self.decode(enc_out, hidden0, labels)

    def decode(self, enc_out, hidden0, labels,
               generator: torch.Generator | None = None, *,
               teacher_rate: float = 0.0,
               teacher_mask: torch.Tensor | None = None):
        """Greedy decode; with ``teacher_mask`` (steps, B) bool, or with
        ``teacher_rate`` > 0 (the mask drawn from ``generator`` before any
        dropout mask of the decoder), step t + 1's input is ``labels[:, t +
        1]`` where the mask's row t is set.  Without either nothing is
        drawn: free running.  In eval mode the whole loop is the span
        ``R.decode`` (``utils/profiling.span``)."""
        with span("R.decode", not self.training):
            steps = self.output_max_len - 1
            if teacher_mask is None and teacher_rate > 0:
                teacher_mask = batch_random(
                    torch.rand, (steps, labels.shape[0]), generator,
                    labels.device, batch_dim=1) < teacher_rate
            hidden = hidden0
            attn = enc_out.new_zeros(enc_out.shape[:2])
            prev = labels[:, 0]
            logits, attns = [], []
            for t in range(steps):
                hidden, attn, step_logits = self.dec(hidden, attn, prev,
                                                     enc_out, generator)
                prev = step_logits.argmax(dim=-1)  # ties: first index, as jnp
                if teacher_mask is not None:
                    prev = torch.where(teacher_mask[t],
                                       labels[:, t + 1].long(), prev)
                logits.append(step_logits)
                attns.append(attn)
            return torch.stack(logits, dim=1), torch.stack(attns, dim=1)

    def beam_search(self, img, beam_size: int = 3,
                    eos_id: int = VOCAB.end):
        """Batched beam search over (B * K) rows, as the JAX package's
        ``Recognizer.beam_search``: log-softmax scores, beams 1..K-1 seeded
        at -1e9 so the first step expands beam 0 only, and a finished beam
        extends only with ``eos_id``, at cost 0.  Returns (tokens (B, T -
        1), scores (B,)) of each sample's best hypothesis.  Call it in eval
        mode (no dropout, running statistics).

        The top K of each row are taken by a stable descending sort, so
        equal scores keep the lower index first, as ``lax.top_k`` does;
        ``torch.topk`` promises no order among ties on CUDA."""
        k, b = beam_size, img.shape[0]
        steps = self.output_max_len - 1
        enc_out, hidden0 = self.enc(img)
        v = self.dec.out.out_features
        dev = enc_out.device
        hidden = hidden0.repeat_interleave(k, dim=1)          # (2, BK, H)
        enc = enc_out.repeat_interleave(k, dim=0)
        attn = enc.new_zeros(enc.shape[:2])
        last = torch.full((b * k,), VOCAB.go, dtype=torch.long, device=dev)
        scores = torch.tensor([0.0] + [-1e9] * (k - 1), device=dev).repeat(b)
        alive = torch.ones(b * k, dtype=torch.bool, device=dev)
        seq = torch.zeros((b * k, steps), dtype=torch.long, device=dev)
        frozen = torch.full((v,), -torch.inf, device=dev)
        frozen[eos_id] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * k
        for t in range(steps):
            hidden, attn, logits = self.dec(hidden, attn, last, enc)
            logp = torch.log_softmax(logits.float(), dim=-1)
            logp = torch.where(alive[:, None], logp, frozen)
            total = (scores[:, None] + logp).reshape(b, k * v)
            top_scores, top_idx = torch.sort(total, dim=-1, descending=True,
                                              stable=True)
            top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
            parent = (top_idx // v + rows).reshape(-1)
            last = (top_idx % v).reshape(-1)
            hidden, attn = hidden[:, parent], attn[parent]
            scores = top_scores.reshape(-1)
            alive = alive[parent] & (last != eos_id)
            seq = seq[parent]
            seq[:, t] = last
        scores = scores.reshape(b, k)
        best = scores.argmax(dim=-1)
        pick = torch.arange(b, device=dev)
        return seq.reshape(b, k, steps)[pick, best], scores[pick, best]
