"""Typed configuration for the word-level AFFGAN stack.

The port's own copy of ``affganwriting_tpu/core/config.py`` (importing that
module would pull jax in through its package ``__init__``).  Field names,
defaults and the JSON form are the same, so one JSON string configures both
packages.
"""

from __future__ import annotations

import dataclasses
import json
import string
from typing import Any


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Charset a-zA-Z plus GO/END/PAD control tokens (ids 0/1/2)."""

    letters: str = string.ascii_lowercase + string.ascii_uppercase
    go: int = 0
    end: int = 1
    pad: int = 2

    @property
    def num_tokens(self) -> int:
        return 3

    @property
    def size(self) -> int:
        return len(self.letters) + self.num_tokens  # 55

    def encode(self, word: str) -> list[int]:
        idx = {c: i for i, c in enumerate(self.letters)}
        return [idx[c] + self.num_tokens for c in word]

    def decode(self, ids) -> str:
        return "".join(self.letters[int(i) - self.num_tokens] for i in ids
                       if int(i) >= self.num_tokens)

    def pad_label(self, word: str, max_len: int) -> list[int]:
        """GO + chars + END, padded with PAD to ``max_len``."""
        ll = [self.go] + self.encode(word) + [self.end]
        return ll + [self.pad] * (max_len - len(ll))


VOCAB = Vocab()


@dataclasses.dataclass(frozen=True)
class WordGanConfig:
    """Hyper-parameters of the word-level GAN; every field of the JAX
    package's ``WordGanConfig``, with the same defaults.  This slice reads
    the geometry, model and ``compute_dtype`` fields; the rest ride along so
    a config round-trips through both packages."""

    # --- geometry ---
    img_height: int = 64
    img_width: int = 216
    max_chars: int = 10
    style_stack: int = 50
    num_writers: int = 500
    # --- model ---
    style_encoder: str = "resnet50"
    style_dim: int = 512
    text_embed_dim: int = 64
    adain_param_dim: int = 4096
    dis_layers: int = 6
    dis_final_size: int = 1024
    recognizer: str = "seq2seq"
    rec_frozen: bool = False
    trocr_preset: str = "tiny"
    trocr_map_vec: tuple = ()
    trocr_valid_mask: tuple = ()
    rec_hidden: int = 512
    rec_embed: int = 60
    attn_filters: int = 128
    attn_kernel: int = 7
    rec_scan_unroll: int = 1
    label_smoothing: float = 0.4
    # --- training ---
    optimizer: str = "adam"
    batch_size: int = 8
    lr_dis: float = 1e-4
    lr_gen: float = 1e-4
    lr_rec: float = 1e-5
    lr_cla: float = 1e-5
    w_dis: float = 1.0
    w_cla: float = 1.0
    w_l1: float = 0.0
    w_rec: float = 1.0
    oov: bool = True
    # --- execution ---
    merge_dg: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"

    @property
    def output_max_len(self) -> int:
        return self.max_chars + 2  # <GO> + chars + <END>

    @property
    def vocab_size(self) -> int:
        return VOCAB.size

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "WordGanConfig":
        raw: dict[str, Any] = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        # JSON has no tuples; the tuple-typed fields come back as tuples
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in raw.items() if k in fields})

    def replace(self, **kw) -> "WordGanConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> WordGanConfig:
    return WordGanConfig()
