"""Batched character error rate (CER) on the tensor's own device.

The port of ``affganwriting_tpu/eval/cer.py``: control tokens (GO, END,
PAD) are stripped by a stable compaction, then the Levenshtein DP runs for
the whole batch at once, row by row with the column recurrence as a loop,
over (B,) tensors.  The loops are Python over tiny tensors, which is fine:
the trainer calls this once per batch after the epoch's steps.  The
protocol is the reference's, ``100 * sum(edits) / sum(len(gt))``
(GAN_word/loss_tro.py:43-72).
"""

from __future__ import annotations

import torch

from affganwriting_torch.core.config import VOCAB


def strip_tokens(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Remove GO/END/PAD ids anywhere, compacting the letters to the front:
    ids (B, T) -> (compacted (B, T), lengths (B,))."""
    keep = ids >= VOCAB.num_tokens
    # a stable sort of ``not keep`` moves the kept positions forward in order
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    return torch.gather(ids, -1, order), keep.sum(-1)


def batched_levenshtein(a: torch.Tensor, a_len: torch.Tensor,
                        b: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """Edit distances (B,) between the first ``a_len`` ids of each row of
    ``a`` (B, La) and the first ``b_len`` of ``b`` (B, Lb)."""
    n, la = a.shape
    lb = b.shape[1]
    prev = torch.arange(lb + 1, device=a.device).expand(n, lb + 1)
    for i in range(la):
        live = i < a_len                       # rows past a_len stay frozen
        left = torch.where(live, torch.full_like(a_len, i + 1), prev[:, 0])
        row = [left]
        for j in range(lb):
            cost = (a[:, i] != b[:, j]).long()
            val = torch.minimum(torch.minimum(left + 1, prev[:, j + 1] + 1),
                                prev[:, j] + cost)
            left = torch.where(live, val, prev[:, j + 1])
            row.append(left)
        prev = torch.stack(row, dim=1)
    return torch.gather(prev, 1, b_len[:, None].long())[:, 0]


def cer_counts(pred_ids: torch.Tensor, gt_ids: torch.Tensor):
    """(sum of edit distances, sum of GT lengths) after stripping the
    control tokens; ``pred_ids``, ``gt_ids`` (B, T) label ids."""
    p, p_len = strip_tokens(pred_ids)
    g, g_len = strip_tokens(gt_ids)
    return batched_levenshtein(p, p_len, g, g_len).sum(), g_len.sum()


def wer(pred_texts: list[str], gt_texts: list[str]) -> float:
    """Word error rate over text pairs: word-level Levenshtein over the
    reference word count (line_generation/utils/error_rates.py:1-27)."""
    ed_sum, n_sum = 0, 0
    for p, g in zip(pred_texts, gt_texts):
        pw, gw = p.split(), g.split()
        vocab = {w: i for i, w in enumerate(dict.fromkeys(pw + gw))}
        dp = list(range(len(gw) + 1))
        for i, wp in enumerate(pw, 1):
            prev = dp[0]
            dp[0] = i
            for j, wg in enumerate(gw, 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                            prev + (vocab[wp] != vocab[wg]))
                prev = cur
        ed_sum += dp[len(gw)]
        n_sum += len(gw)
    return ed_sum / max(n_sum, 1)


class CERAccumulator:
    """Streaming CER over batches."""

    def __init__(self):
        self.ed = 0
        self.length = 0

    def add(self, pred_ids: torch.Tensor, gt_ids: torch.Tensor) -> None:
        ed, ln = cer_counts(pred_ids, gt_ids)
        self.ed += int(ed)
        self.length += int(ln)

    def add_logits(self, logits: torch.Tensor, gt_ids: torch.Tensor) -> None:
        self.add(logits.argmax(-1), gt_ids)

    def value(self) -> float:
        if self.length == 0:
            return 0.0
        return 100.0 * self.ed / self.length
