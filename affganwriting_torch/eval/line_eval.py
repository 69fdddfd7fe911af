"""Dataset-wide line evaluation.

The port of ``affganwriting_tpu/eval/line_eval.py`` (the reference's
line_generation/new_eval.py + evaluators/hwdataset_eval.py): over a split,
compute (a) the reconstruction L1, (b) the CER/WER of the frozen recognizer
on real lines (naive CTC decode, trainer:904-924), (c) its CER on
*generated* lines (legibility), and collect style vectors for writer
retrieval (``gen/line_inference.writer_retrieval``).

Kept from the JAX package as it is (ROADMAP Queue 3, "Found in the
reference"): the DTW-spaced label of each batch is computed and never
used, and the "reconstruction" is a second free generation from the
label, not a regeneration on the spaced one.  The JAX function draws that
generation's noise, spacing and dropout from one key; here every draw of
the evaluation comes from one ``torch.Generator`` seeded from ``seed``.
The models run on the trainer's device.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from affganwriting_torch.eval.cer import wer
from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.gen.line_inference import (
    StyleLibrary,
    writer_retrieval,
)


def _levenshtein(a: str, b: str) -> int:
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev = dp[0]
        dp[0] = i
        for j, cb in enumerate(b, 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
            prev = cur
    return dp[len(b)]


@torch.no_grad()
def evaluate_lines(trainer, state, batches, charset, seed: int = 0,
                   max_batches: int | None = None) -> dict:
    """``rec_cer``, ``gen_cer`` (percent), ``recon_l1``, ``wer`` and, with
    more than one author, ``top1``/``top5`` writer retrieval."""
    dev = resolve_device(trainer.device)
    gen = torch.Generator(dev).manual_seed(seed)
    model = state.model
    rec_eds, rec_lens = 0, 0
    gen_eds, gen_lens = 0, 0
    l1s = []
    pred_texts, gt_texts = [], []
    styles, authors = [], []

    for batch in itertools.islice(batches, max_batches):
        img = trainer._put_image(batch["image"])
        label = trainer._put(batch["label"], torch.long)
        lengths = trainer._put(batch["label_lengths"], torch.long)

        # (a)+(b): the recognizer on real lines
        logp = model.recognize(img).float().cpu().numpy()
        style, _ = model.extract_style(img)
        styles.append(style.float().cpu().numpy())
        authors.extend(batch["authors"])

        gen_img, _, _ = model(label, lengths, style, generator=gen)
        gen_logp = model.recognize(gen_img).float().cpu().numpy()

        for i in range(img.shape[0]):
            ids = np.asarray(batch["label"][i])
            gt = charset.decode(ids[: int(batch["label_lengths"][i])])
            pred = charset.ctc_collapse(np.argmax(logp[i], axis=-1))
            gen_pred = charset.ctc_collapse(np.argmax(gen_logp[i], axis=-1))
            rec_eds += _levenshtein(pred, gt)
            rec_lens += max(len(gt), 1)
            gen_eds += _levenshtein(gen_pred, gt)
            gen_lens += max(len(gt), 1)
            pred_texts.append(pred)
            gt_texts.append(gt)

        # the reference's reconstruction L1: its spaced label (DTW) is
        # computed and not used; the line is generated from the label
        spaced = trainer.spaced_label(state, batch)
        t = trainer.max_gen_length
        sp = np.zeros((spaced.shape[0], t), spaced.dtype)
        sp[:, : min(t, spaced.shape[1])] = spaced[:, :t]
        recon, _, _ = model(label, lengths, style, generator=gen)
        w = min(recon.shape[3], img.shape[3])
        l1s.append(float((recon[..., :w].float()
                          - img[..., :w].float()).abs().mean()))

    library = StyleLibrary(
        np.concatenate(styles) if styles else np.zeros((0, 1)),
        authors, list(range(len(authors))))
    out = {
        "rec_cer": 100.0 * rec_eds / max(rec_lens, 1),
        "gen_cer": 100.0 * gen_eds / max(gen_lens, 1),
        "recon_l1": float(np.mean(l1s)) if l1s else 0.0,
        "wer": wer(pred_texts, gt_texts) if pred_texts else 0.0,
    }
    if len(set(authors)) > 1:
        out.update(writer_retrieval(library, top_k=(1, 5)))
    return out
