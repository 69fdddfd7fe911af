"""Inputs from the seed: the corpus, the synthetic word renderer, the style
pool and the label encoding.

The renderer is the port's procedural 'handwriting' (three Gaussian strokes
a character, a writer-dependent slant), seeded from a stable hash
(``zlib.crc32``) where the port seeds from ``hash(word)``, which changes with
``PYTHONHASHSEED``.  It draws its few random numbers on the host and renders
all images in bulk on the device.
"""

from __future__ import annotations

import string
import zlib
from pathlib import Path

import numpy as np
import torch

CORPUS = Path(__file__).resolve().parent.parent / "data" / "brown-azAZ.tr"
LETTERS = string.ascii_lowercase + string.ascii_uppercase
GO, END, PAD = 0, 1, 2


def corpus(max_chars: int = 10) -> list[str]:
    """The Brown corpus words of 1 to ``max_chars`` letters, in file order."""
    words = CORPUS.read_text().split()
    return [w for w in words
            if 1 <= len(w) <= max_chars and all(c in LETTERS for c in w)]


def encode_labels(words: list[str], max_len: int) -> np.ndarray:
    """GO + letters + END, PAD to ``max_len``: (B, max_len) int64."""
    idx = {c: i + 3 for i, c in enumerate(LETTERS)}
    out = np.full((len(words), max_len), PAD, np.int64)
    for r, w in enumerate(words):
        ids = [GO] + [idx[c] for c in w[:max_len - 2]] + [END]
        out[r, :len(ids)] = ids
    return out


def _stroke_params(word: str, writer: int, height: int, width: int):
    rng = np.random.default_rng(
        zlib.crc32(word.encode()) ^ (writer * 2654435761 & 0xFFFFFFFF))
    n = max(1, len(word))
    char_w = min(20, width // (n + 1))
    rows = []
    for i, ch in enumerate(word[:10]):
        cx = 8 + i * char_w + char_w / 2
        cy = height / 2 + float(rng.normal(0, 4))
        for s in range(3):
            rows.append((cx, cy, (ord(ch) * 0.7 + s * 2.1) % np.pi))
    return rows


def render(words: list[str], writers: list[int], height: int, width: int,
           device, chunk: int = 128) -> torch.Tensor:
    """(N, height, width) f32 images in [-1, 1] of ``words[i]`` in writer
    ``writers[i]``'s slant, rendered on ``device``."""
    n_strokes = 30
    params = np.zeros((len(words), n_strokes, 4), np.float32)
    for i, (w, wr) in enumerate(zip(words, writers)):
        rows = _stroke_params(w, wr, height, width)
        params[i, :len(rows), :3] = rows
        params[i, :len(rows), 3] = 1.0
    slant = torch.tensor([(wr % 7 - 3) * 0.08 for wr in writers],
                         dtype=torch.float32, device=device)
    p = torch.from_numpy(params).to(device)
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    out = torch.empty(len(words), height, width, device=device)
    for s in range(0, len(words), chunk):
        q = p[s:s + chunk, :, :, None, None]
        sl = slant[s:s + chunk, None, None, None]
        cx, cy, ang, on = q[:, :, 0], q[:, :, 1], q[:, :, 2], q[:, :, 3]
        dx, dy = torch.cos(ang), torch.sin(ang)
        t = (xx - cx) * dx + (yy - cy) * dy + sl * (yy - cy)
        r = -(xx - cx) * dy + (yy - cy) * dx
        img = (on * torch.exp(-t.square() / 72.0 - r.square() / 8.0)).sum(1)
        out[s:s + chunk] = (img.clamp(0, 1) - 0.5) / 0.5
    return out


class StylePool:
    """``writers`` writers, each with ``stack`` words of the corpus rendered
    in its slant: ``stacks`` (writers, H, W, stack) f32 on the host,
    ``words[w][k]`` the word of image k of writer w, ``ids`` the writers'
    ids in ``num_writers``."""

    def __init__(self, seed: int, cfg: dict, writers: int, device):
        rng = np.random.default_rng([seed, 1])
        vocab = corpus(cfg["max_chars"])
        h, w, k = cfg["img_height"], cfg["img_width"], cfg["style_stack"]
        self.ids = rng.choice(cfg["num_writers"], writers, replace=False)
        self.words = [[vocab[j] for j in rng.integers(len(vocab), size=k)]
                      for _ in range(writers)]
        flat = [wd for ws in self.words for wd in ws]
        owner = [int(i) for i in self.ids for _ in range(k)]
        imgs = render(flat, owner, h, w, device)
        self.stacks = (imgs.view(writers, k, h, w).permute(0, 2, 3, 1)
                       .contiguous().cpu().numpy())
