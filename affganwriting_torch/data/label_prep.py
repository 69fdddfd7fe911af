"""Label preparation utilities (GAN_word/forlabels/*, prepare_dataset.sh).

The port's copy of ``affganwriting_tpu/data/label_prep.py`` (plain Python,
the same results): split, clean and merge IAM ground-truth label files and
flatten nested word image directories, on the port's
``core/config.VOCAB``."""

from __future__ import annotations

import os
import shutil

from affganwriting_torch.core.config import VOCAB


def clean_gt_lines(lines: list[str], max_chars: int = 10) -> list[str]:
    """Keep entries whose word is fully in the a-zA-Z charset and within the
    length cap (the 'filter27'-style cleaning)."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        head, *word = line.split(" ")
        w = " ".join(word)
        if 0 < len(w) <= max_chars and all(c in VOCAB.letters for c in w):
            out.append(f"{head} {w}")
    return out


def split_gt_by_writers(path: str, train_frac: float = 0.7
                        ) -> tuple[list[str], list[str]]:
    """Split a GT file into train/test by writer id (first-appearance
    order), keeping each writer wholly in one split."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    writers: list[str] = []
    for ln in lines:
        wid = ln.split(",")[0]
        if wid not in writers:
            writers.append(wid)
    cut = int(len(writers) * train_frac)
    train_w = set(writers[:cut])
    train = [ln for ln in lines if ln.split(",")[0] in train_w]
    test = [ln for ln in lines if ln.split(",")[0] not in train_w]
    return train, test


def merge_gt_files(paths: list[str], out_path: str) -> int:
    seen = set()
    merged = []
    for p in paths:
        with open(p) as f:
            for ln in f:
                ln = ln.strip()
                if ln and ln not in seen:
                    seen.add(ln)
                    merged.append(ln)
    with open(out_path, "w") as f:
        f.write("\n".join(merged) + "\n")
    return len(merged)


def flatten_image_tree(src_root: str, dst_root: str,
                       exts=(".png", ".jpg")) -> int:
    """Flatten nested IAM word dirs into one flat dir of <img_id>.ext
    (prepare_dataset.sh:1-4)."""
    os.makedirs(dst_root, exist_ok=True)
    n = 0
    for dirpath, _, files in os.walk(src_root):
        for name in files:
            if os.path.splitext(name)[1].lower() in exts:
                shutil.copy2(os.path.join(dirpath, name),
                             os.path.join(dst_root, name))
                n += 1
    return n
