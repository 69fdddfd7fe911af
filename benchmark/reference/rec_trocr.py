"""The reference's TrOCR recognizer (the AFFGANwriting TrOCR variant,
GAN_word trocr_recognizer.py:48-247): a pre-norm ViT encoder and a
post-norm TrOCR decoder with cross attention, teacher-forced on the labels
in one pass, its tokenizer logits gathered onto the 55 symbols; and its tap
on the program's R, which has the same modules under the same names
(``core.encoder.layer0.attn.query``, ...).

``PRESETS`` keeps the widths of the port's two presets: ``base``,
microsoft/trocr-base-handwritten (arXiv:2109.10282; its config.json): a
ViT-base/16 over 384 x 384 (577 tokens with the class token; 12 layers of
768, 12 heads, MLP 3,072, exact GELU), a decoder of 12 layers of 1,024, 16
heads, FFN 4,096, causal self attention, cross attention whose k and v read
the encoder's 768 (``cross_attention_hidden_size``), learned positions
offset by 2, ``layernorm_embedding``, a bias-free output projection onto
the 50,265 tokens; and ``tiny``, the CPU tests' widths.  Attention is plain
``q @ k^T``, softmax and ``@ v``; every dense layer and the patch
convolution is a ``Layer``, so the control rounds them.

The preprocess is the published one in plain ops: [-1, 1] to [0, 1], three
channels, an aspect-keeping bilinear resize (a 64 x 216 word to 114 x 384),
zeros right and bottom to 384 x 384, then (x - 0.5) / 0.5.

Departures from the published model, the port's too:

- LayerNorm eps 1e-6 everywhere (published: 1e-12 in the ViT, 1e-5 in the
  decoder);
- masked classes (GO and PAD) read -30 where the source fills -1e9;
- without a table in the configuration, the char->token table is GO -> 0,
  PAD -> 1, END -> 2, letter c -> 10 + ord(c), not the RoBERTa tokenizer's
  first token of each letter;
- the output projection is a matrix of its own, not tied to the token
  embedding (R holds 384.8 M parameters at ``base``, not the published
  334 M);
- the weights are random, from the seed.

R is teacher-forced: decoder input t is ``labels[:, t]`` through the table,
so logit t predicts ``labels[:, t + 1]``, and it never reads its own ids.
``forward``'s ``feed`` therefore changes nothing: the serving judge hands R
the program's greedy ids there, which a greedy R reads back and this one
does not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import (Attention, Conv, Dense, LayerNorm,
                                        resize_bilinear)

GO, END, PAD = 0, 1, 2
LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
MASK_FILL = -30.0
PRESETS = {
    "base": dict(enc_hidden=768, enc_layers=12, enc_heads=12, enc_mlp=3072,
                 image_size=384, patch=16, dec_hidden=1024, dec_layers=12,
                 dec_heads=16, dec_ffn=4096, vocab=50265, max_positions=512,
                 cross_kv=768),
    "tiny": dict(enc_hidden=32, enc_layers=2, enc_heads=2, enc_mlp=64,
                 image_size=384, patch=16, dec_hidden=32, dec_layers=2,
                 dec_heads=2, dec_ffn=64, vocab=384, max_positions=64,
                 cross_kv=None),
}


def char_table(cfg: dict, vocab: int) -> tuple[list[int], list[bool]]:
    """(token id, live) of each of the 55 symbols: the configuration's
    table, else the default one; END and the letters are live."""
    if cfg.get("trocr_map_vec"):
        return list(cfg["trocr_map_vec"]), list(cfg["trocr_valid_mask"])
    ids = [0] * (3 + len(LETTERS))
    ids[GO], ids[PAD], ids[END] = 0, 1, 2
    for i, c in enumerate(LETTERS):
        ids[3 + i] = (10 + ord(c)) % vocab
    return ids, [i == END or i >= 3 for i in range(len(ids))]


def preprocess(img, size: int):
    """(B, 1, H, W) in [-1, 1] -> (B, 3, size, size), normalised."""
    x = ((img.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    h, w = x.shape[2:]
    scale = min(size / max(1, h), size / max(1, w))
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    x = resize_bilinear(x, (nh, nw)).expand(-1, 3, -1, -1)
    x = F.pad(x, (0, size - nw, 0, size - nh))
    return (x - 0.5) / 0.5


class ViTLayer(nn.Module):
    def __init__(self, d, heads, mlp):
        super().__init__()
        self.ln_before, self.attn = LayerNorm(d), Attention(d, heads)
        self.ln_after = LayerNorm(d)
        self.fc1, self.fc2 = Dense(d, mlp), Dense(mlp, d)

    def forward(self, x):
        x = x + self.attn(self.ln_before(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln_after(x))))


class ViTEncoder(nn.Module):
    """Patches, the class token, learned positions, the pre-norm layers and
    a final LayerNorm (HF ``ViTModel`` without its pooler)."""

    def __init__(self, w):
        super().__init__()
        d, n = w["enc_hidden"], (w["image_size"] // w["patch"]) ** 2
        self.patch_proj = Conv(3, d, w["patch"], w["patch"])
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, d))
        self.layers = w["enc_layers"]
        for i in range(self.layers):
            self.add_module(f"layer{i}",
                            ViTLayer(d, w["enc_heads"], w["enc_mlp"]))
        self.ln_final = LayerNorm(d)

    def forward(self, pixels):
        x = self.patch_proj(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        x = x + self.pos_embed
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x)
        return self.ln_final(x)


class DecAttention(nn.Module):
    """TrOCR's attention: q scaled by head_dim^-1/2 after its projection;
    k and v from ``kv`` (width ``kv_dim``) or from x itself, causal."""

    def __init__(self, d, heads, kv_dim, causal=False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.q_proj, self.out_proj = Dense(d, d), Dense(d, d)
        self.k_proj, self.v_proj = Dense(kv_dim, d), Dense(kv_dim, d)

    def forward(self, x, kv=None):
        kv = x if kv is None else kv
        hd = x.shape[-1] // self.heads

        def split(h):
            return h.view(h.shape[0], h.shape[1], self.heads,
                          hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        k, v = split(self.k_proj(kv)), split(self.v_proj(kv))
        scores = q @ k.transpose(-1, -2)
        if self.causal:
            t = x.shape[1]
            future = torch.ones(t, t, dtype=torch.bool,
                                device=x.device).triu(1)
            scores = scores.masked_fill(future, float("-inf"))
        ctx = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(ctx.transpose(1, 2).reshape(x.shape))


class DecoderLayer(nn.Module):
    """Post-norm: LN(x + self attn), LN(x + cross attn), LN(x + FFN)."""

    def __init__(self, w, kv_dim):
        super().__init__()
        d, h = w["dec_hidden"], w["dec_heads"]
        self.self_attn = DecAttention(d, h, d, causal=True)
        self.self_attn_ln = LayerNorm(d)
        self.encoder_attn = DecAttention(d, h, kv_dim)
        self.encoder_attn_ln = LayerNorm(d)
        self.fc1, self.fc2 = Dense(d, w["dec_ffn"]), Dense(w["dec_ffn"], d)
        self.final_ln = LayerNorm(d)

    def forward(self, x, enc):
        x = self.self_attn_ln(x + self.self_attn(x))
        x = self.encoder_attn_ln(x + self.encoder_attn(x, enc))
        return self.final_ln(x + self.fc2(F.gelu(self.fc1(x))))


class TrOCRDecoder(nn.Module):
    def __init__(self, w, kv_dim):
        super().__init__()
        d = w["dec_hidden"]
        self.embed_tokens = nn.Embedding(w["vocab"], d)
        self.embed_positions = nn.Parameter(
            torch.empty(w["max_positions"] + 2, d))
        self.ln_embed = LayerNorm(d)
        self.layers = w["dec_layers"]
        for i in range(self.layers):
            self.add_module(f"layer{i}", DecoderLayer(w, kv_dim))
        self.output_projection = Dense(d, w["vocab"], bias=False)

    def forward(self, ids, enc):
        x = F.embedding(ids, self.embed_tokens.weight)
        x = self.ln_embed(x + self.embed_positions[2:ids.shape[1] + 2])
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x, enc)
        return self.output_projection(x)


class TrOCRCore(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.encoder = ViTEncoder(w)
        kv_dim = w["enc_hidden"] if w["cross_kv"] else w["dec_hidden"]
        if not w["cross_kv"] and w["enc_hidden"] != w["dec_hidden"]:
            self.enc_to_dec_proj = Dense(w["enc_hidden"], w["dec_hidden"])
        self.decoder = TrOCRDecoder(w, kv_dim)


class Recognizer(nn.Module):
    """``forward(img (B, 1, H, W), labels (B, T)) -> logits (B, T - 1,
    55)``, masked classes at ``MASK_FILL``; ``gen`` and ``feed`` change
    nothing (no dropout; teacher-forced)."""

    def __init__(self, w, cfg: dict):
        super().__init__()
        self.size = w["image_size"]
        self.table, self.live = char_table(cfg, w["vocab"])
        self.core = TrOCRCore(w)

    def forward(self, img, labels, gen=None, feed=None):
        enc = self.core.encoder(preprocess(img, self.size))
        if hasattr(self.core, "enc_to_dec_proj"):
            enc = self.core.enc_to_dec_proj(enc)
        table = torch.as_tensor(self.table, device=labels.device)
        live = torch.as_tensor(self.live, device=labels.device)
        tokens = self.core.decoder(table[labels[:, :-1].long()], enc)
        logits = tokens.index_select(-1, table)
        return torch.where(live, logits, logits.new_full((), MASK_FILL))


def build(cfg: dict, p: float = 0.5) -> nn.Module:
    return Recognizer(PRESETS[cfg["trocr_preset"]], cfg)


class Tap:
    """R's logits as R returned them, and the ids it fed itself
    (``labels[:, :-1]``), read by a forward hook on R itself, one call a
    call of R: the program's ``TrOCRRecognizer`` returns (logits, None),
    the reference its logits.  The hook keeps references only, so a take
    inside a timed window launches nothing on the device."""

    def __init__(self, rec: nn.Module, cfg: dict):
        self.read = []
        self.handle = rec.register_forward_hook(self.hook, with_kwargs=True)

    def hook(self, mod, args, kwargs, out):
        labels = args[1] if len(args) > 1 else kwargs["labels"]
        logits = out[0] if isinstance(out, tuple) else out
        self.read.append((logits.detach(), labels[:, :-1]))

    def take(self):
        read, self.read = self.read, []
        return lambda: list(read)

    def remove(self) -> None:
        self.handle.remove()
