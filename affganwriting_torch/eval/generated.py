"""CER over a folder of generated images, parsed from filenames.

The port of ``affganwriting_tpu/eval/generated.py`` (the reference's
GAN_word/evaluate_cer_generated.py): filenames are
``<wid>-<n>.<GT>-<pred>.png``; CER = 100 * sum(edit) / sum(len(GT)).  The
edit distances of the whole folder run as one batched call of
``eval/cer.py:batched_levenshtein`` on the host.

``cli/generate_word`` writes ``<name>.png.npy`` where PIL is absent (the
card's machine has none), so ``<name>.png.npy`` counts as ``<name>.png``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.eval.cer import batched_levenshtein

IMAGE_EXTS = (".png", ".jpg", ".jpeg")
NPY_SUFFIX = ".png.npy"


def parse_generated_name(name: str):
    """'049-3.three-threw.png' (or '.png.npy') -> ('three', 'threw'), or
    None for a name that is not a generated word's."""
    if name.lower().endswith(NPY_SUFFIX):
        name = name[: -len(".npy")]
    stem, ext = os.path.splitext(name)
    if ext.lower() not in IMAGE_EXTS:
        return None
    dot = stem.find(".")
    if dot < 0:
        return None
    pair = stem[dot + 1:]
    if "-" not in pair:
        return None
    gt, pred = pair.split("-", 1)
    return gt, pred


def cer_of_folder(folder: str) -> dict:
    pairs = []
    for name in sorted(os.listdir(folder)):
        parsed = parse_generated_name(name)
        if parsed:
            pairs.append(parsed)
    return cer_of_pairs(pairs)


def cer_of_pairs(pairs: list[tuple[str, str]]) -> dict:
    """CER over (GT, pred) text pairs; characters outside the vocabulary's
    letters are dropped before the distance."""
    if not pairs:
        return {"cer": 0.0, "count": 0}
    max_len = max(1, max(max(len(g), len(p)) for g, p in pairs))

    def encode(ws):
        ids = np.zeros((len(ws), max_len), np.int64)
        lens = np.zeros(len(ws), np.int64)
        for i, w in enumerate(ws):
            e = VOCAB.encode("".join(ch for ch in w if ch in VOCAB.letters))
            ids[i, : len(e)] = e
            lens[i] = len(e)
        return torch.from_numpy(ids), torch.from_numpy(lens)

    g_ids, g_len = encode([g for g, _ in pairs])
    p_ids, p_len = encode([p for _, p in pairs])
    edits = int(batched_levenshtein(p_ids, p_len, g_ids, g_len).sum())
    total_len = int(g_len.sum())
    return {
        "cer": 100.0 * float(edits) / max(total_len, 1),
        "count": len(pairs),
        "edits": edits,
        "ref_len": total_len,
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("folder")
    args = p.parse_args(argv)
    print(cer_of_folder(args.folder))


if __name__ == "__main__":
    main()
