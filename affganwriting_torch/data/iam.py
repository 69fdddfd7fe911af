"""IAM word-level ground truth: per-writer word lists and writer labels.

The port's copy of ``affganwriting_tpu/data/iam.py``.  The ground-truth and
corpus files are data: the port keeps its own copy in ``data/assets/``
(``AFFGAN_WORD_DATA`` points elsewhere).
Writers are labelled in first-appearance order of the GT file, as the
reference's hardcoded maps were built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

ASSETS = Path(__file__).resolve().parent / "assets"


@dataclass(frozen=True)
class WordEntry:
    writer: str     # e.g. '049'
    img_id: str     # e.g. 'a03-034-00-00'
    word: str       # ground-truth transcription


def parse_groundtruth(path: str) -> dict[str, list[WordEntry]]:
    """GT file (lines ``<writer>,<img-id> <word...>``) -> {writer_id:
    [WordEntry, ...]} in file order."""
    out: dict[str, list[WordEntry]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head, *word_parts = line.split(" ")
            writer, img_id = head.split(",")
            out.setdefault(writer, []).append(
                WordEntry(writer, img_id, " ".join(word_parts)))
    return out


def writer_label_map(by_writer: dict[str, list[WordEntry]]) -> dict[str, int]:
    """writer-id -> integer label, in first-appearance order."""
    return {wid: i for i, wid in enumerate(by_writer.keys())}


def load_corpus(path: str) -> list[str]:
    """Word list corpus: one word per whitespace."""
    with open(path) as f:
        return f.read().split()


def default_reference_paths(base: str | None = None) -> dict[str, str]:
    """Paths of the GT and corpus files under ``base``, else
    ``AFFGAN_WORD_DATA``, else the in-repo assets."""
    base = base or os.environ.get("AFFGAN_WORD_DATA", str(ASSETS))
    return {
        "train_gt": os.path.join(
            base, "groundtruth", "gan.iam.tr_va.gt.filter27"),
        "test_gt": os.path.join(
            base, "groundtruth", "gan.iam.test.gt.filter27"),
        "corpus": os.path.join(base, "corpora", "brown-azAZ.tr"),
        "oov_corpus": os.path.join(base, "corpora", "oov.common_words"),
    }
