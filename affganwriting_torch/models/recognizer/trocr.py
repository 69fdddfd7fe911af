"""TrOCR drop-in recognizer R: a ViT encoder and a TrOCR decoder whose
tokenizer logits are gathered back onto the 55-symbol vocabulary.

Port of ``affganwriting_tpu/models/recognizer/trocr.py`` (the reference's
``TrOCRRecModel``, GAN_word/trocr_recognizer.py:48-247).  The module names
follow the flax tree (``core.encoder.layer0.attn.query``, ...), so
``utils/from_flax`` converts a flax ``TrOCRRecognizer`` by its generic
rules, and ``import_torch_state_dict`` maps a HuggingFace
``VisionEncoderDecoderModel`` state dict onto ``TrOCRCore``.

Numerics, held to the JAX package's:

- TrOCR runs in f32 whatever ``compute_dtype`` is.  The JAX module's Dense
  layers have f32 parameters and no ``dtype``, so flax promotes bf16 fakes
  to f32; here the preprocessed pixels are cast to f32, the parameters stay
  f32 and nothing runs under autocast.
- Every LayerNorm uses flax's default eps, 1e-6.  HF's ViT uses 1e-12 and
  HF's TrOCR decoder 1e-5, so on an imported HF state dict the port (like
  the JAX package) differs slightly from ``transformers``' own output.
- GELU is the exact form (``approximate="none"``), unlike the DINOv2 style
  encoders' tanh form.
- Attention heads are (b, t, heads, head_dim), head-major.  The encoder's
  and the cross attention go through ``F.scaled_dot_product_attention``;
  the decoder's causal self attention fills the future with -1e9 and takes
  its softmax in f32, as the JAX package does.
- The decoder's learned positions start at row 2 of their table (BART's
  offset), and its ``output_projection`` is a separate, bias-free matrix.

The preprocess is differentiable, so R's loss reaches G's fakes; TrOCR's own
weights are frozen by the caller (``rec_frozen``).

In eval mode ``TrOCRRecognizer.forward`` opens the spans ``R.preprocess``
(resize and pad), ``R.encode`` (the ViT), ``R.decode`` (the char->token
ids, the embedding, the decoder layers and the output projection) and
``R.vocab`` (the gather onto the 55 symbols, the mask and the padding),
under ``gen/inference.py``'s ``R`` (``utils/profiling.span``).  The
benchmark's float32 reference of this module is
``benchmark/reference/rec_trocr.py``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.models.blocks import resize_bilinear
from affganwriting_torch.utils.profiling import span

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TrOCRArch:
    """Dimensions of the ViT-encoder / TrOCR-decoder pair."""

    enc_hidden: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    enc_mlp: int = 3072
    image_size: int = 384
    patch_size: int = 16
    dec_hidden: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_ffn: int = 4096
    vocab_tro: int = 50265
    max_positions: int = 512
    scale_embedding: bool = False
    layernorm_embedding: bool = True
    # None: an ``enc_to_dec_proj`` linear when the widths differ; an int:
    # the cross attention's k and v read the encoder's width directly
    # (trocr-base-handwritten sets 768)
    cross_attention_hidden_size: int | None = None

    @classmethod
    def base_handwritten(cls) -> "TrOCRArch":
        """microsoft/trocr-base-handwritten's dimensions."""
        return cls(cross_attention_hidden_size=768)

    @classmethod
    def tiny(cls) -> "TrOCRArch":
        """Tiny dimensions for tests and weightless runs."""
        return cls(enc_hidden=32, enc_layers=2, enc_heads=2, enc_mlp=64,
                   dec_hidden=32, dec_layers=2, dec_heads=2, dec_ffn=64,
                   vocab_tro=384, max_positions=64)

    @property
    def uses_enc_to_dec_proj(self) -> bool:
        return (self.cross_attention_hidden_size is None
                and self.enc_hidden != self.dec_hidden)

    @property
    def cross_kv_dim(self) -> int:
        return (self.enc_hidden if self.cross_attention_hidden_size
                is not None else self.dec_hidden)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, t, heads * hd) -> (b, heads, t, hd), head-major."""
    b, t, d = x.shape
    return x.view(b, t, heads, d // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


# --------------------------------------------------------------------------
# ViT encoder (pre-norm)
# --------------------------------------------------------------------------


class ViTSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(hidden, hidden))

    def forward(self, x):
        q, k, v = (_heads(proj(x), self.heads)
                   for proj in (self.query, self.key, self.value))
        return self.out(_merge(F.scaled_dot_product_attention(q, k, v)))


class ViTLayer(nn.Module):
    """HF ``ViTLayer``: x + attn(LN(x)), then x + fc2(gelu(fc1(LN(x))))."""

    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.ln_before = _layer_norm(hidden)
        self.attn = ViTSelfAttention(hidden, heads)
        self.ln_after = _layer_norm(hidden)
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)

    def forward(self, x):
        x = x + self.attn(self.ln_before(x))
        h = F.gelu(self.fc1(self.ln_after(x)), approximate="none")
        return x + self.fc2(h)


class ViTEncoder(nn.Module):
    """HF ``ViTModel`` without its pooler: patches, a class token, learned
    positions, the pre-norm blocks and a final LayerNorm."""

    def __init__(self, arch: TrOCRArch):
        super().__init__()
        a = arch
        n = (a.image_size // a.patch_size) ** 2
        self.patch_proj = nn.Conv2d(3, a.enc_hidden, a.patch_size,
                                    stride=a.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, a.enc_hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, a.enc_hidden))
        self.layers = a.enc_layers
        for i in range(a.enc_layers):
            self.add_module(f"layer{i}", ViTLayer(a.enc_hidden, a.enc_heads,
                                                  a.enc_mlp))
        self.ln_final = _layer_norm(a.enc_hidden)

    def forward(self, pixels):                       # (B, 3, S, S) f32
        x = self.patch_proj(pixels).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x)
        return self.ln_final(x)


# --------------------------------------------------------------------------
# TrOCR decoder (post-norm, causal, with cross attention)
# --------------------------------------------------------------------------


class TrOCRAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_dim: int,
                 causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.scaling = (hidden // heads) ** -0.5
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(kv_dim, hidden)
        self.v_proj = nn.Linear(kv_dim, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, kv=None):
        kv = x if kv is None else kv
        q = _heads(self.q_proj(x) * self.scaling, self.heads)
        k, v = _heads(self.k_proj(kv), self.heads), _heads(self.v_proj(kv),
                                                           self.heads)
        if self.causal:
            t, s = q.shape[2], k.shape[2]
            scores = q @ k.transpose(-1, -2)
            mask = torch.ones(t, s, dtype=torch.bool,
                              device=x.device).tril()
            attn = torch.softmax(scores.masked_fill(~mask, -1e9).float(), -1)
            ctx = attn @ v
        else:
            ctx = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        return self.out_proj(_merge(ctx))


class TrOCRDecoderLayer(nn.Module):
    """Post-norm: LN(x + self_attn), LN(x + cross_attn), LN(x + FFN)."""

    def __init__(self, arch: TrOCRArch):
        super().__init__()
        a = arch
        self.self_attn = TrOCRAttention(a.dec_hidden, a.dec_heads,
                                        a.dec_hidden, causal=True)
        self.self_attn_ln = _layer_norm(a.dec_hidden)
        self.encoder_attn = TrOCRAttention(a.dec_hidden, a.dec_heads,
                                           a.cross_kv_dim)
        self.encoder_attn_ln = _layer_norm(a.dec_hidden)
        self.fc1 = nn.Linear(a.dec_hidden, a.dec_ffn)
        self.fc2 = nn.Linear(a.dec_ffn, a.dec_hidden)
        self.final_ln = _layer_norm(a.dec_hidden)

    def forward(self, x, enc):
        x = self.self_attn_ln(x + self.self_attn(x))
        x = self.encoder_attn_ln(x + self.encoder_attn(x, enc))
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.final_ln(x + h)


class TrOCRDecoder(nn.Module):
    def __init__(self, arch: TrOCRArch):
        super().__init__()
        a = self.arch = arch
        self.embed_tokens = nn.Embedding(a.vocab_tro, a.dec_hidden)
        self.embed_positions = nn.Parameter(
            torch.zeros(a.max_positions + 2, a.dec_hidden))
        if a.layernorm_embedding:
            self.ln_embed = _layer_norm(a.dec_hidden)
        for i in range(a.dec_layers):
            self.add_module(f"layer{i}", TrOCRDecoderLayer(a))
        self.output_projection = nn.Linear(a.dec_hidden, a.vocab_tro,
                                           bias=False)

    def forward(self, input_ids, enc):               # (B, T), (B, S, E)
        a = self.arch
        x = self.embed_tokens(input_ids)
        if a.scale_embedding:
            x = x * float(np.sqrt(a.dec_hidden))
        t = input_ids.shape[1]
        x = x + self.embed_positions[2:t + 2][None]
        if a.layernorm_embedding:
            x = self.ln_embed(x)
        for i in range(a.dec_layers):
            x = getattr(self, f"layer{i}")(x, enc)
        return self.output_projection(x)


class TrOCRCore(nn.Module):
    """pixels (B, 3, S, S) + decoder input ids (B, T) -> tokenizer logits
    (B, T, vocab_tro); HF ``VisionEncoderDecoderModel``'s forward.
    ``encode`` and ``decode`` are its halves (a greedy decode encodes
    once)."""

    def __init__(self, arch: TrOCRArch):
        super().__init__()
        self.arch = arch
        self.encoder = ViTEncoder(arch)
        if arch.uses_enc_to_dec_proj:
            self.enc_to_dec_proj = nn.Linear(arch.enc_hidden,
                                             arch.dec_hidden)
        self.decoder = TrOCRDecoder(arch)

    def encode(self, pixels):
        enc = self.encoder(pixels.float())
        if self.arch.uses_enc_to_dec_proj:
            enc = self.enc_to_dec_proj(enc)
        return enc

    def decode(self, input_ids, enc):
        return self.decoder(input_ids, enc)

    def forward(self, pixels, input_ids):
        return self.decode(input_ids, self.encode(pixels))


# --------------------------------------------------------------------------
# the 55-symbol vocabulary <-> tokenizer ids
# --------------------------------------------------------------------------


def default_char_token_table(vocab_tro: int) -> tuple[np.ndarray, np.ndarray]:
    """(map_vec (55,), valid_mask (55,)) without a tokenizer: GO -> <s> (0),
    PAD -> <pad> (1), END -> </s> (2), letter c -> 10 + ord(c) (mod
    ``vocab_tro``).  END is a live class; GO and PAD are masked."""
    v = VOCAB.size
    map_vec = np.zeros((v,), np.int64)
    valid = np.zeros((v,), bool)
    map_vec[VOCAB.go], map_vec[VOCAB.pad], map_vec[VOCAB.end] = 0, 1, 2
    valid[VOCAB.end] = True
    for i, ch in enumerate(VOCAB.letters):
        map_vec[VOCAB.num_tokens + i] = (10 + ord(ch)) % vocab_tro
        valid[VOCAB.num_tokens + i] = True
    return map_vec, valid


def table_from_tokenizer(tokenizer) -> tuple[np.ndarray, np.ndarray]:
    """(map_vec, valid_mask) from a HF tokenizer: each letter's first token
    id (trocr_recognizer.py:143-160), the specials from its bos, pad and
    eos ids."""
    v = VOCAB.size
    map_vec = np.zeros((v,), np.int64)
    valid = np.zeros((v,), bool)
    map_vec[VOCAB.go] = int(tokenizer.bos_token_id or 0)
    map_vec[VOCAB.pad] = int(tokenizer.pad_token_id or 1)
    map_vec[VOCAB.end] = int(tokenizer.eos_token_id or 2)
    valid[VOCAB.end] = True
    for i, ch in enumerate(VOCAB.letters):
        ids = tokenizer(ch, add_special_tokens=False)["input_ids"]
        if ids:
            map_vec[VOCAB.num_tokens + i] = int(ids[0])
            valid[VOCAB.num_tokens + i] = True
    return map_vec, valid


# --------------------------------------------------------------------------
# differentiable preprocess
# --------------------------------------------------------------------------


def preprocess_for_trocr(img: torch.Tensor, size: int = 384,
                         mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """(B, 1, H, W) in [-1, 1] -> (B, 3, size, size) f32, normalized: to
    [0, 1], three channels, an aspect-keeping bilinear resize
    (``jax.image.resize``'s), zeros right and bottom, then ``(x - mean) /
    std`` (trocr_recognizer.py:48-76, :199-203).  Differentiable."""
    x = ((img.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    _, _, h, w = x.shape
    scale = min(size / max(1, h), size / max(1, w))
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    x = resize_bilinear(x, (nh, nw)).expand(-1, 3, -1, -1)
    x = F.pad(x, (0, size - nw, 0, size - nh))
    return (x - mean) / std


# --------------------------------------------------------------------------
# the drop-in recognizer
# --------------------------------------------------------------------------


class TrOCRRecognizer(nn.Module):
    """R with the seq2seq ``Recognizer``'s contract: ``forward(img (B, 1,
    H, W), labels (B, T)) -> (logits (B, T - 1, 55) f32, None)``.  Decoder
    input t is ``labels[:, t]`` through the char->token table, so
    ``logits[:, t]`` predicts ``labels[:, t + 1]``; masked classes read
    ``MASK_FILL``.  It has no dropout and no batch statistics: the train
    mode and the ``generator`` change nothing."""

    # the reference fills -1e9, which blows up the label-smoothed KL (the
    # smoothing mass lands on masked classes); -30 keeps their probability
    # at e^-30 with a bounded loss
    MASK_FILL = -30.0

    def __init__(self, arch: TrOCRArch, output_max_len: int = 12,
                 map_vec=(), valid_mask=()):
        super().__init__()
        self.arch, self.output_max_len = arch, output_max_len
        self.core = TrOCRCore(arch)
        if len(map_vec):
            mv = np.asarray(map_vec, np.int64)
            vm = np.asarray(valid_mask, bool)
        else:
            mv, vm = default_char_token_table(arch.vocab_tro)
        self.register_buffer("map_vec", torch.as_tensor(mv),
                             persistent=False)
        self.register_buffer("valid_mask", torch.as_tensor(vm),
                             persistent=False)

    def vocab_logits(self, logits_tro: torch.Tensor) -> torch.Tensor:
        """Tokenizer logits (..., vocab_tro) -> (..., 55), masked."""
        logits = logits_tro.index_select(-1, self.map_vec)
        return torch.where(self.valid_mask, logits,
                           logits.new_full((), self.MASK_FILL))

    def forward(self, img, labels, generator: torch.Generator | None = None):
        serving = not self.training
        with span("R.preprocess", serving):
            pixels = preprocess_for_trocr(img, self.arch.image_size)
        with span("R.encode", serving):
            enc = self.core.encode(pixels)
        with span("R.decode", serving):
            logits = self.core.decode(self.map_vec[labels[:, :-1].long()],
                                      enc)
        with span("R.vocab", serving):
            logits = self.vocab_logits(logits)
            t, want = logits.shape[1], self.output_max_len - 1
            if t < want:
                pad = logits.new_full((logits.shape[0], want - t,
                                       logits.shape[-1]), self.MASK_FILL)
                logits = torch.cat([logits, pad], dim=1)
            return logits[:, :want].float(), None


# --------------------------------------------------------------------------
# HuggingFace weights
# --------------------------------------------------------------------------


def import_torch_state_dict(sd, arch: TrOCRArch) -> dict:
    """A HF ``VisionEncoderDecoderModel.state_dict()`` (ViT encoder, TrOCR
    decoder) -> a state dict for the port's ``TrOCRCore(arch)``.  HF's
    pooler and anything else ``TrOCRCore`` lacks is left out."""

    def t(name):
        return sd[name].detach().float().cpu().clone()

    out = {
        "encoder.patch_proj.weight":
            t("encoder.embeddings.patch_embeddings.projection.weight"),
        "encoder.patch_proj.bias":
            t("encoder.embeddings.patch_embeddings.projection.bias"),
        "encoder.cls_token": t("encoder.embeddings.cls_token"),
        "encoder.pos_embed": t("encoder.embeddings.position_embeddings"),
        "decoder.embed_tokens.weight":
            t("decoder.model.decoder.embed_tokens.weight"),
        "decoder.embed_positions":
            t("decoder.model.decoder.embed_positions.weight"),
        "decoder.output_projection.weight":
            t("decoder.output_projection.weight"),
    }

    def copy(ours: str, theirs: str, leaves=("weight", "bias")):
        for leaf in leaves:
            out[f"{ours}.{leaf}"] = t(f"{theirs}.{leaf}")

    copy("encoder.ln_final", "encoder.layernorm")
    for i in range(arch.enc_layers):
        ours, theirs = f"encoder.layer{i}", f"encoder.encoder.layer.{i}"
        copy(f"{ours}.ln_before", f"{theirs}.layernorm_before")
        copy(f"{ours}.ln_after", f"{theirs}.layernorm_after")
        for proj in ("query", "key", "value"):
            copy(f"{ours}.attn.{proj}",
                 f"{theirs}.attention.attention.{proj}")
        copy(f"{ours}.attn.out", f"{theirs}.attention.output.dense")
        copy(f"{ours}.fc1", f"{theirs}.intermediate.dense")
        copy(f"{ours}.fc2", f"{theirs}.output.dense")
    if arch.layernorm_embedding:
        copy("decoder.ln_embed", "decoder.model.decoder.layernorm_embedding")
    for i in range(arch.dec_layers):
        ours, theirs = f"decoder.layer{i}", f"decoder.model.decoder.layers.{i}"
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                copy(f"{ours}.{attn}.{proj}", f"{theirs}.{attn}.{proj}")
        copy(f"{ours}.self_attn_ln", f"{theirs}.self_attn_layer_norm")
        copy(f"{ours}.encoder_attn_ln", f"{theirs}.encoder_attn_layer_norm")
        copy(f"{ours}.fc1", f"{theirs}.fc1")
        copy(f"{ours}.fc2", f"{theirs}.fc2")
        copy(f"{ours}.final_ln", f"{theirs}.final_layer_norm")
    if "enc_to_dec_proj.weight" in sd:
        copy("enc_to_dec_proj", "enc_to_dec_proj")
    return out


def load_pretrained(ckpt_dir: str, arch: TrOCRArch | None = None):
    """A local HF TrOCR checkpoint directory -> (``TrOCRCore`` state dict,
    map_vec, valid_mask); the table comes from the directory's tokenizer,
    or ``default_char_token_table`` without one.  ``None`` when the
    directory or ``transformers`` is missing.  Nothing is fetched."""
    if not os.path.isdir(ckpt_dir):
        return None
    try:
        from transformers import TrOCRProcessor, VisionEncoderDecoderModel
    except Exception:
        return None
    model = VisionEncoderDecoderModel.from_pretrained(
        ckpt_dir, local_files_only=True)
    arch = arch or TrOCRArch.base_handwritten()
    state = import_torch_state_dict(model.state_dict(), arch)
    try:
        proc = TrOCRProcessor.from_pretrained(ckpt_dir, local_files_only=True)
        mv, vm = table_from_tokenizer(proc.tokenizer)
    except Exception:
        mv, vm = default_char_token_table(arch.vocab_tro)
    return state, mv, vm
