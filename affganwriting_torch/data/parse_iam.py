"""IAM form-XML parsing: line bounding boxes + writer ids.

The port's copy of ``affganwriting_tpu/data/parse_iam.py`` (numpy and
PIL, bit-equal), the reference's ``utils/parseIAM.py``:
``getLineBoundariesWithID`` (:137-185) walks an IAM form XML's
``handwritten-part/line`` elements, unions the component (``cmp``) boxes of
every word into a per-line bbox, then normalizes the boxes against the
form's mean line height: short lines are vertically centered out to the
mean height and every box gets a horizontal margin of mean-height/4.

:class:`AuthorLinesIndex` groups the XMLs by form page into the
train/valid/test splits of ``sets.json`` (the port's line assets, as
``data/lines.py`` reads them) and the lines by
writer id, so that items are drawn as ``a_batch_size`` same-author groups
(datasets/author_hw_dataset.py:141-199).  :class:`AuthorLineDataset` is
the real-image drop-in for ``data/lines.LineDataset``.

Kept from the JAX package: a line whose form page is missing becomes a
synthetic line seeded from ``hash(author) & 0xFFFF``.  Python salts
string hashes per process, so that image changes with ``PYTHONHASHSEED``;
two packages agree on it only within one process.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

import numpy as np

from affganwriting_torch.data.line_augment import augment_line, foreground_mask
from affganwriting_torch.data.lines import (
    bucket_width,
    load_sets,
    synthetic_line_image,
)


@dataclass(frozen=True)
class LineRecord:
    bounds: tuple[int, int, int, int]   # (y0, y1, x0, x1) crop slice bounds
    text: str
    line_id: str
    writer: str
    form: str                           # form/page id, e.g. "a01-000u"


def parse_form_xml(xml_path: str) -> list[LineRecord]:
    """Parse one IAM form XML into per-line records.

    Mirrors getLineBoundariesWithID (parseIAM.py:137-185): per-line bbox is
    the union of word ``cmp`` boxes with +1 on the max edges; then every
    line shorter than the form's mean height is vertically centered out to
    the mean, and all lines get +-meanH/4 horizontal margin.  Lines whose
    words carry no ``cmp`` boxes are skipped (degenerate bbox).
    """
    tree = ET.parse(xml_path)
    root = tree.getroot()
    writer = root.attrib["writer-id"]
    form = os.path.splitext(os.path.basename(xml_path))[0]

    raw = []
    total_h = 0
    for line in root.findall("./handwritten-part/line"):
        text = line.attrib["text"]
        line_id = line.attrib["id"]
        min_x = min_y = 10 ** 9
        max_x = max_y = -1
        for word in line.findall("word"):
            for cmp_el in word.findall("cmp"):
                x = int(cmp_el.attrib["x"])
                y = int(cmp_el.attrib["y"])
                w = int(cmp_el.attrib["width"])
                h = int(cmp_el.attrib["height"])
                min_x, max_x = min(min_x, x), max(max_x, x + w)
                min_y, max_y = min(min_y, y), max(max_y, y + h)
        if max_x < 0:
            continue
        raw.append(([min_y, max_y + 1, min_x, max_x + 1], text, line_id))
        total_h += 1 + max_y - min_y
    if not raw:
        return []
    mean_h = total_h / len(raw)

    records = []
    for bounds, text, line_id in raw:
        b = list(bounds)
        diff = mean_h - (b[1] - b[0])
        if diff > 0:
            b[0] -= diff / 2
            b[1] += diff / 2
        b[2] -= mean_h / 4
        b[3] += mean_h / 4
        b = tuple(int(round(v)) for v in b)
        records.append(LineRecord(b, text, line_id, writer, form))
    return records


class AuthorLinesIndex:
    """All lines of an IAM checkout, split by sets.json and grouped by
    writer (author_hw_dataset.py:141-199 semantics)."""

    def __init__(self, xml_dir: str, sets_path: Optional[str] = None,
                 split: str = "train"):
        sets = load_sets() if sets_path is None else load_sets(sets_path)
        wanted = set(sets[split])

        self.by_author: dict[str, list[LineRecord]] = {}
        for name in sorted(os.listdir(xml_dir)):
            if not name.endswith(".xml"):
                continue
            form = name[:-4]
            if form not in wanted:
                continue
            for rec in parse_form_xml(os.path.join(xml_dir, name)):
                self.by_author.setdefault(rec.writer, []).append(rec)

    @property
    def authors(self) -> list[str]:
        return sorted(self.by_author)

    def __len__(self) -> int:
        return sum(len(v) for v in self.by_author.values())


def load_form_image(image_dir: str, form: str) -> Optional[np.ndarray]:
    """Form page image as float32 grayscale in [0, 1], or None if absent.

    IAM distributes forms as ``forms/<form>.png``; a flat directory is
    accepted too.
    """
    for cand in (os.path.join(image_dir, form),       # RIMES: full filename
                 os.path.join(image_dir, f"{form}.png"),
                 os.path.join(image_dir, "forms", f"{form}.png")):
        if os.path.exists(cand):
            from PIL import Image

            with Image.open(cand) as im:
                arr = np.asarray(im.convert("L"), np.float32) / 255.0
            return arr
    return None


def crop_line(form_img: np.ndarray, rec: LineRecord,
              img_height: int = 64) -> np.ndarray:
    """Crop a line box out of its form page and resize to ``img_height``
    preserving aspect; output float32 in [-1, 1] with ink positive
    (inverted, like the word pipeline).  (B&W IAM pages are white-bg.)"""
    h, w = form_img.shape
    y0, y1, x0, x1 = rec.bounds
    y0, x0 = max(0, y0), max(0, x0)
    y1, x1 = min(h, y1), min(w, x1)
    crop = form_img[y0:y1, x0:x1]
    if crop.size == 0:
        crop = np.ones((img_height, img_height), np.float32)
    ch, cw = crop.shape
    new_w = max(1, int(round(cw * img_height / ch)))
    # PIL resize (host-side decode path; the jit preprocess handles
    # normalization-sensitive work on device)
    from PIL import Image

    im = Image.fromarray((crop * 255).astype(np.uint8))
    im = im.resize((new_w, img_height), Image.BILINEAR)
    arr = np.asarray(im, np.float32) / 255.0
    return (1.0 - arr) * 2.0 - 1.0   # invert: ink -> +1, bg -> -1


class AuthorLineDataset:
    """Real-image drop-in for ``LineDataset``: author-grouped line batches
    from an IAM XML+forms checkout (author_hw_dataset.py:54-136).

    Each batch stacks ``batch_authors * a_batch_size`` lines; images are
    right-padded to the batch's bucketed width with the background value
    (the reference's PADDING_CONSTANT -1, :76).
    """

    def __init__(self, index: AuthorLinesIndex, image_dir: str,
                 charset, a_batch_size: int = 2, img_height: int = 64,
                 max_width: int = 2048, label_len: int = 96, seed: int = 0,
                 augment: bool = False, with_fg_mask: bool = False):
        self.index = index
        self.image_dir = image_dir
        self.charset = charset
        self.a_batch_size = a_batch_size
        self.img_height = img_height
        self.max_width = max_width
        self.label_len = label_len
        self.seed = seed
        # train-time augmentation chain (author_hw_dataset.py:291-299) and
        # Otsu fg masks for the no-background pixel loss (:200-229)
        self.augment = augment
        self.with_fg_mask = with_fg_mask
        # authors need >= a_batch_size lines to form a group
        self.authors = [a for a in index.authors
                        if len(index.by_author[a]) >= a_batch_size]
        self._form_cache: dict[str, Optional[np.ndarray]] = {}

    def _form(self, form: str) -> Optional[np.ndarray]:
        if form not in self._form_cache:
            self._form_cache[form] = load_form_image(self.image_dir, form)
            if len(self._form_cache) > 8:   # bounded page cache
                self._form_cache.pop(next(iter(self._form_cache)))
        return self._form_cache[form]

    def _line_image(self, rec: LineRecord) -> Optional[np.ndarray]:
        form = self._form(rec.form)
        if form is None:
            return None
        img = crop_line(form, rec, self.img_height)
        return img[:, : self.max_width]

    def batches(self, batch_authors: int = 2, epoch: int = 0):
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.authors))
        ab = self.a_batch_size
        for start in range(0, len(order) - batch_authors + 1, batch_authors):
            entries = []
            for ai in order[start: start + batch_authors]:
                author = self.authors[ai]
                recs = self.index.by_author[author]
                pick = rng.choice(len(recs), size=ab, replace=len(recs) < ab)
                for ri in pick:
                    rec = recs[int(ri)]
                    img = self._line_image(rec)
                    text = rec.text
                    if img is None:
                        # form image missing: deterministic synthetic
                        # fallback (same policy as the word pipeline);
                        # the label must describe the rendered prefix
                        img, text = synthetic_line_image(
                            rec.text[:40], hash(author) & 0xFFFF,
                            self.img_height, 512, return_text=True)
                    entries.append((author, text, img))

            if self.augment:
                entries = [
                    (author, text,
                     1.0 - 2.0 * augment_line((1.0 - img) / 2.0, rng))
                    for author, text, img in entries]

            widths = [e[2].shape[1] for e in entries]
            bw = bucket_width(max(widths), max_width=self.max_width)
            n = len(entries)
            images = np.full((n, self.img_height, bw, 1), -1.0, np.float32)
            labels = np.zeros((n, self.label_len), np.int32)
            lengths = np.zeros((n,), np.int32)
            if self.with_fg_mask:
                masks = np.zeros((n, self.img_height, bw, 1), np.float32)
            authors, texts = [], []
            for i, (author, text, img) in enumerate(entries):
                w = min(img.shape[1], bw)
                images[i, :, :w, 0] = img[:, :w]
                if self.with_fg_mask:
                    masks[i, :, :w, 0] = foreground_mask(
                        (1.0 - img[:, :w]) / 2.0)
                ids = self.charset.encode(text)[: self.label_len]
                labels[i, : len(ids)] = ids
                lengths[i] = len(ids)
                authors.append(author)
                texts.append(text)
            out = {
                "image": images,
                "label": labels,
                "label_lengths": lengths,
                "authors": authors,
                "texts": texts,
                "a_batch_size": ab,
            }
            if self.with_fg_mask:
                out["fg_mask"] = masks
            yield out
