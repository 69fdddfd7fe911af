"""Line-level data: the IAM charset and splits, random text, line batches.

The port's copy of ``affganwriting_tpu/data/lines.py`` (numpy, bit-equal
batches): the 79-char + CTC blank charset (``IAM_char_set.json``), the
form-page splits (``sets.json``) and ``TextData`` (random text snippets
from ``lotr.txt``; line_generation/datasets/text_data.py:6-110).  The
three files are data: the port keeps its own copy in ``data/assets/line/``
(``AFFGAN_LINE_DATA`` points elsewhere).  ``LineDataset`` renders
deterministic synthetic lines
(``data/words.synthetic_word_image``, seeded from ``hash(author)``: the
lines repeat only within one process); it keeps an ``image_root`` as the
JAX class does, which reads nothing from it either.  Batches are NHWC numpy arrays in [-1, 1]; the
trainer moves them to the device as NCHW.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np

from affganwriting_torch.data.words import synthetic_word_image

# the port's line assets; AFFGAN_LINE_DATA overrides
_REF_DATA = os.environ.get(
    "AFFGAN_LINE_DATA",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                 "line"))


class LineCharset:
    """char <-> id map; id 0 is the CTC blank (IAM_char_set.json)."""

    def __init__(self, path: str = os.path.join(_REF_DATA,
                                                "IAM_char_set.json")):
        with open(path) as f:
            raw = json.load(f)
        self.char_to_idx: dict[str, int] = raw["char_to_idx"]
        self.idx_to_char = {int(k): v for k, v in raw["idx_to_char"].items()}
        self.n_class = max(self.char_to_idx.values()) + 1   # 80 incl. blank

    def encode(self, text: str) -> list[int]:
        return [self.char_to_idx[c] for c in text if c in self.char_to_idx]

    def decode(self, ids) -> str:
        return "".join(
            self.idx_to_char.get(int(i), "") for i in ids if int(i) != 0)

    def ctc_collapse(self, ids) -> str:
        out, prev = [], -1
        for i in ids:
            i = int(i)
            if i != prev and i != 0:
                out.append(self.idx_to_char.get(i, ""))
            prev = i
        return "".join(out)


def load_sets(path: str = os.path.join(_REF_DATA, "sets.json")) -> dict:
    with open(path) as f:
        return json.load(f)


class TextData:
    """Random text snippets from a corpus file (text_data.py:6-110)."""

    def __init__(self, charset: LineCharset,
                 path: str = os.path.join(_REF_DATA, "lotr.txt"),
                 max_len: int = 40, seed: int = 0):
        with open(path, errors="ignore") as f:
            text = f.read().replace("\n", " ")
        self.words = [w for w in text.split(" ") if w]
        self.charset = charset
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)

    def sample(self, rng: np.random.Generator | None = None) -> str:
        """One text snippet.  Pass ``rng`` to draw from a caller-keyed
        stream (deterministic data: LineDataset.batches keys one rng per
        (seed, epoch) so repeated iteration yields identical batches —
        validation determinism depends on this); default draws advance
        the instance's own stream."""
        rng = self.rng if rng is None else rng
        start = int(rng.integers(len(self.words) - 12))
        out = ""
        for w in self.words[start: start + 12]:
            cand = (out + " " + w).strip()
            if len(cand) > self.max_len:
                break
            out = cand
        return out or self.words[start][: self.max_len]

    def batch(self, batch_size: int, label_len: int):
        texts = [self.sample() for _ in range(batch_size)]
        labels = np.zeros((batch_size, label_len), np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        for i, t in enumerate(texts):
            ids = self.charset.encode(t)[:label_len]
            labels[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return {"label": labels, "label_lengths": lengths, "texts": texts}


def synthetic_line_image(text: str, author_seed: int, height: int = 64,
                         width: int = 512, return_text: bool = False):
    """Deterministic synthetic line built from word blobs.

    Only words that FULLY fit are drawn, and ``return_text=True`` also
    returns the text actually rendered: a label describing glyphs the
    image does not contain is an irreducible CER floor (pre-round-4 this
    clipped tails silently — the HWR pretrain plateaued at ~35% CER
    because most 46-char labels outran the 512px canvas)."""
    img = np.full((height, width), -1.0, np.float32)
    drawn: list[str] = []
    x = 4
    for word in text.split(" "):
        if not word:
            x += 12
            continue
        w_need = min(18 * len(word) + 8, 216)
        if x + w_need > width:
            break
        wimg = synthetic_word_image(word, author_seed, height, 216)
        img[:, x: x + w_need] = np.maximum(
            img[:, x: x + w_need], wimg[:, :w_need])
        drawn.append(word)
        x += w_need + 6
    if not drawn and text.strip():
        # canvas narrower than the first word: draw its visible prefix so
        # image and label stay consistent even in the degenerate case
        word = text.split()[0]
        n = max(1, (width - 12) // 18)
        word = word[:n]
        w_need = min(18 * len(word) + 8, 216, width - 4)
        wimg = synthetic_word_image(word, author_seed, height, 216)
        img[:, 4: 4 + w_need] = np.maximum(
            img[:, 4: 4 + w_need], wimg[:, :w_need])
        drawn = [word]
    if return_text:
        return img, " ".join(drawn)
    return img


def bucket_width(width: int, bucket: int = 128, max_width: int = 2048) -> int:
    """Round a natural line width up to its bucket: a few static shapes
    instead of one per width (the reference pads every batch to its own
    max width, author_hw_dataset.py collate)."""
    b = ((max(width, 1) + bucket - 1) // bucket) * bucket
    return min(b, max_width)


def bucketize(items: list[dict], bucket: int = 128, batch_size: int = 4,
              max_width: int = 2048):
    """Group {image (H, W, 1), ...} items by bucketed width; yield padded
    batches per bucket.  Images are right-padded with the background value
    (-1); a 'width' array records the true widths for masking."""
    groups: dict[int, list[dict]] = {}
    for it in items:
        w = it["image"].shape[1]
        groups.setdefault(bucket_width(w, bucket, max_width), []).append(it)
    for bw in sorted(groups):
        batch = groups[bw]
        for start in range(0, len(batch), batch_size):
            chunk = batch[start: start + batch_size]
            h = chunk[0]["image"].shape[0]
            imgs = np.full((len(chunk), h, bw, 1), -1.0, np.float32)
            widths = np.zeros((len(chunk),), np.int32)
            for i, it in enumerate(chunk):
                w = min(it["image"].shape[1], bw)
                imgs[i, :, :w] = it["image"][:, :w]
                widths[i] = w
            out = {"image": imgs, "width": widths}
            for key in chunk[0]:
                if key != "image":
                    vals = [it[key] for it in chunk]
                    out[key] = (np.stack(vals)
                                if isinstance(vals[0], np.ndarray)
                                else vals)
            yield out


class LineDataset:
    """Author-grouped line batches (author_hw_dataset.py:54-141 semantics):
    each item is ``a_batch_size`` same-author lines so the style extractor
    can width-concatenate them."""

    def __init__(self, charset: LineCharset, authors: Optional[list] = None,
                 texts_per_author: int = 8, a_batch_size: int = 2,
                 width: int = 512, label_len: int = 48,
                 image_root: Optional[str] = None, seed: int = 0):
        self.charset = charset
        self.a_batch_size = a_batch_size
        self.width = width
        self.label_len = label_len
        self.image_root = image_root
        self.seed = seed
        self.text_data = TextData(charset, max_len=label_len - 2, seed=seed)
        self.authors = authors or [f"a{i:03d}" for i in range(16)]
        self.texts_per_author = texts_per_author

    def batches(self, batch_authors: int = 2, epoch: int = 0,
                ) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.authors))
        ab = self.a_batch_size
        for start in range(0, len(order) - batch_authors + 1, batch_authors):
            images, labels, lengths, authors = [], [], [], []
            texts = []
            for ai in order[start: start + batch_authors]:
                author = self.authors[ai]
                for _ in range(ab):
                    text = self.text_data.sample(rng)
                    img, drawn = synthetic_line_image(
                        text, hash(author) & 0xFFFF, width=self.width,
                        return_text=True)
                    # the label is what the image SHOWS (see
                    # synthetic_line_image: clipped tails were a CER floor)
                    ids = self.charset.encode(drawn)[: self.label_len]
                    images.append(img)
                    lab = np.zeros((self.label_len,), np.int32)
                    lab[: len(ids)] = ids
                    labels.append(lab)
                    lengths.append(max(len(ids), 1))
                    authors.append(author)
                    texts.append(drawn)
            yield {
                "image": np.stack(images)[..., None].astype(np.float32),
                "label": np.stack(labels),
                "label_lengths": np.asarray(lengths, np.int32),
                "authors": authors,
                "texts": texts,
                "a_batch_size": ab,
            }
