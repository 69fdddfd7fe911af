"""Per-writer word dataset: 50-image style stacks and target words.

The port's copy of ``affganwriting_tpu/data/words.py`` (the reference's
``IAM_words``, GAN_word/load_data.py:58-179).  Per sample: shuffle the
writer's words, take 51 (cycling when there are fewer), hold one out as
``img_xt``; the targets are two corpus words (``oov``) or the held-out label
and an edit-distance-1 mutation of it.  All randomness comes from one numpy
``Generator`` per ``(seed, epoch)``, so a pair reproduces its batch stream.

Without an image root or reader, images are rendered procedurally by
``synthetic_word_image``, seeded from ``hash(word)`` as in the JAX package:
Python randomizes string hashes per process, so the synthetic images, and
the batches built from them, repeat only within one process.

Batches are dicts of contiguous NHWC numpy arrays: ``style_imgs`` (B, H, W,
50), ``img_xt`` (B, H, W, 1), ``writer_ids`` (B,), ``label_xt``,
``label_xt_swap``, ``label_ch0`` (B, T); ``train/step.py:to_device_batch``
moves them to the device.
"""

from __future__ import annotations

import functools
import os
import string
from typing import Callable, Iterator, Optional

import numpy as np

from affganwriting_torch.core.config import VOCAB, WordGanConfig
from affganwriting_torch.data.iam import WordEntry


def edits1(word: str, rng: np.random.Generator,
           min_len: int = 2, max_len: int = 10) -> str:
    """One random edit (delete, transpose, replace or insert) of ``word``;
    short words never shrink and maxed-out ones never grow
    (GAN_word/load_data.py:42-55)."""
    letters = string.ascii_lowercase
    splits = [(word[:i], word[i:]) for i in range(len(word) + 1)]
    deletes = [L + R[1:] for L, R in splits if R]
    transposes = [L + R[1] + R[0] + R[2:] for L, R in splits if len(R) > 1]
    replaces = [L + c + R[1:] for L, R in splits if R for c in letters]
    inserts = [L + c + R for L, R in splits for c in letters]
    if len(word) <= min_len:
        pool = sorted(set(transposes + replaces + inserts))
    elif len(word) >= max_len:
        pool = sorted(set(deletes + transposes + replaces))
    else:
        pool = sorted(set(deletes + transposes + replaces + inserts))
    return pool[int(rng.integers(len(pool)))]


def preprocess_word_image(img: np.ndarray, height: int = 64,
                          width: int = 216) -> np.ndarray:
    """Grayscale uint8 or float image -> (height, width) float32 in [-1, 1]:
    resize to ``height`` keeping the aspect (width ``int(w * rate) + 1``),
    invert, crop or zero-pad the width, then ``(x - 0.5) / 0.5``
    (GAN_word/load_data.py:141-167).  A uint8 image goes through the native
    library when it is built (``utils/native.py``)."""
    from affganwriting_torch.utils import native

    if native.available() and np.asarray(img).dtype == np.uint8:
        return native.preprocess_words_native(
            np.asarray(img)[None], height, width)[0]
    img = np.asarray(img, dtype=np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    h, w = img.shape
    new_w = int(w * (height / h)) + 1
    img = 1.0 - _resize_bilinear(img, height, new_w)
    out = np.zeros((height, width), dtype=np.float32)
    cw = min(new_w, width)
    out[:, :cw] = img[:, :cw]
    return (out - 0.5) / 0.5


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize, align_corners=False."""
    ih, iw = img.shape
    ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
    xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


@functools.lru_cache(maxsize=20000)
def _synthetic_cached(word: str, writer_seed: int, height: int,
                      width: int) -> np.ndarray:
    """``synthetic_word_image``, cached: a batch of 8 renders 408 images.
    The cached arrays are read-only."""
    img = synthetic_word_image(word, writer_seed, height, width)
    img.setflags(write=False)
    return img


def synthetic_word_image(word: str, writer_seed: int,
                         height: int = 64, width: int = 216) -> np.ndarray:
    """Deterministic procedural 'handwriting': three Gaussian strokes per
    character, shaped by its code, with a writer-dependent slant."""
    rng = np.random.default_rng(
        (hash(word) & 0xFFFFFFFF) ^ (writer_seed * 2654435761 & 0xFFFFFFFF))
    img = np.zeros((height, width), np.float32)
    n = max(1, len(word))
    char_w = min(20, width // (n + 1))
    slant = (writer_seed % 7 - 3) * 0.08
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i, ch in enumerate(word[:10]):
        cx = 8 + i * char_w + char_w / 2
        cy = height / 2 + float(rng.normal(0, 4))
        for s in range(3):
            ang = (ord(ch) * 0.7 + s * 2.1) % np.pi
            dx, dy = np.cos(ang), np.sin(ang)
            t = (xx - cx) * dx + (yy - cy) * dy + slant * (yy - cy)
            r = -(xx - cx) * dy + (yy - cy) * dx
            img += np.exp(-(t ** 2) / (2 * 36.0) - (r ** 2) / (2 * 4.0))
    img = np.clip(img, 0, 1)
    return (img - 0.5) / 0.5


class WordStyleDataset:
    """Per-writer samples, collated into batch dicts (the tensors of the
    reference's ``sort_batch``, GAN_word/main_runold.py:74-109, in NHWC)."""

    def __init__(
        self,
        by_writer: dict[str, list[WordEntry]],
        label_map: dict[str, int],
        config: WordGanConfig,
        corpus: Optional[list[str]] = None,
        image_reader: Optional[Callable[[WordEntry], np.ndarray]] = None,
        image_root: Optional[str] = None,
        seed: int = 0,
    ):
        self.config = config
        self.by_writer = {w: list(v) for w, v in by_writer.items()}
        self.label_map = label_map
        self.writers = list(by_writer.keys())
        self.corpus = [w for w in (corpus or [])
                       if 0 < len(w) <= config.max_chars]
        self.seed = seed
        if image_reader is not None:
            self.reader = image_reader
        elif image_root is not None:
            self.reader = _DirectoryReader(image_root)
        else:
            self.reader = None  # synthetic

    def __len__(self):
        return len(self.writers)

    def _read(self, entry: WordEntry, writer_label: int) -> np.ndarray:
        cfg = self.config
        if self.reader is None:
            return _synthetic_cached(
                entry.word, writer_label, cfg.img_height, cfg.img_width)
        img = self.reader(entry)
        if img is None:
            # a missing or corrupted image reads as zeros
            # (load_data.py:145-147)
            return np.zeros((cfg.img_height, cfg.img_width), np.float32)
        return preprocess_word_image(img, cfg.img_height, cfg.img_width)

    def style_stack(self, writer: str, rng: np.random.Generator
                    ) -> np.ndarray:
        """(1, H, W, style_stack) float32: the writer's word images
        shuffled by ``rng`` and repeated to fill the stack, the serving
        tools' style input (the JAX package's ``scripts/ab_*.py``)."""
        entries = list(self.by_writer[writer])
        rng.shuffle(entries)
        n = self.config.style_stack
        while len(entries) < n:
            entries = entries + entries[: n - len(entries)]
        label = self.label_map[writer]
        return np.stack([self._read(e, label) for e in entries[:n]],
                        axis=-1)[None].astype(np.float32)

    def sample(self, writer: str, rng: np.random.Generator) -> dict:
        cfg = self.config
        extra = cfg.style_stack + 1
        entries = list(self.by_writer[writer])
        rng.shuffle(entries)
        if len(entries) >= extra:
            chosen = entries[:extra]
        else:
            chosen = list(entries)
            while len(chosen) < extra:
                chosen += entries[: extra - len(chosen)]
        label = self.label_map[writer]
        imgs = np.stack([self._read(e, label) for e in chosen], axis=-1)
        hold = int(rng.integers(extra))

        img_xt = imgs[..., hold:hold + 1]
        if cfg.oov and self.corpus:
            w_xt = self.corpus[int(rng.integers(len(self.corpus)))]
            w_swap = self.corpus[int(rng.integers(len(self.corpus)))]
        else:
            w_xt = _clean(chosen[hold].word, cfg.max_chars)
            w_swap = edits1(w_xt, rng, max_len=cfg.max_chars)
        style = np.delete(imgs, hold, axis=-1)
        remaining = [e for i, e in enumerate(chosen) if i != hold]
        label_ch0 = _clean(remaining[0].word, cfg.max_chars)
        return {
            "style_imgs": style.astype(np.float32),
            "img_xt": img_xt.astype(np.float32),
            "writer_id": np.int32(label),
            "label_xt": np.asarray(
                VOCAB.pad_label(w_xt, cfg.output_max_len), np.int32),
            "label_xt_swap": np.asarray(
                VOCAB.pad_label(w_swap, cfg.output_max_len), np.int32),
            "label_ch0": np.asarray(
                VOCAB.pad_label(label_ch0, cfg.output_max_len), np.int32),
        }

    def batches(self, batch_size: Optional[int] = None, epoch: int = 0,
                shuffle: bool = True, drop_last: bool = True,
                ) -> Iterator[dict]:
        bs = batch_size or self.config.batch_size
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self.writers))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - (bs - 1 if drop_last else 0), bs):
            idxs = order[start:start + bs]
            if drop_last and len(idxs) < bs:
                return
            samples = [self.sample(self.writers[i], rng) for i in idxs]
            yield {
                "style_imgs": np.stack([s["style_imgs"] for s in samples]),
                "img_xt": np.stack([s["img_xt"] for s in samples]),
                "writer_ids": np.stack([s["writer_id"] for s in samples]),
                "label_xt": np.stack([s["label_xt"] for s in samples]),
                "label_xt_swap": np.stack(
                    [s["label_xt_swap"] for s in samples]),
                "label_ch0": np.stack([s["label_ch0"] for s in samples]),
            }


def _clean(word: str, max_chars: int) -> str:
    """Keep a-zA-Z and clip the length (the GT files are already filtered;
    this guards other input)."""
    w = "".join(c for c in word if c in VOCAB.letters)
    return (w or "a")[:max_chars]


class _DirectoryReader:
    """Reads ``<root>/<img_id>.png`` as grayscale; None if missing or
    unreadable (PIL is optional)."""

    def __init__(self, root: str):
        self.root = root

    def __call__(self, entry: WordEntry):
        path = os.path.join(self.root, entry.img_id + ".png")
        if not os.path.exists(path):
            return None
        try:
            from PIL import Image
            with Image.open(path) as im:
                return np.asarray(im.convert("L"))
        except Exception:
            return None
