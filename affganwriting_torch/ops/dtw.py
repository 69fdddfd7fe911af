"""Batch-vectorized DTW alignment of CTC predictions to labels.

The port's copy of ``affganwriting_tpu/ops/dtw.py`` (numpy, bit-equal; the
reference's ``correct_pred``, line_generation/model/hw_with_style.py:18-74):
the label is interleaved with CTC blanks (blank, c1, blank, c2, ...), then a
banded DTW aligns it to the per-timestep prediction scores (cost
1 - p(char)); the backtraced path re-labels every prediction timestep, the
"spaced label" that the count lesson and the autoencode lessons consume.
The forward DP is vectorized over the batch; the backtrace walks each
line.  It runs on the host: it feeds the data, not the gradient.
"""

from __future__ import annotations

import numpy as np


def interleave_blanks(label: np.ndarray) -> np.ndarray:
    """(T, B) -> (2T+1, B) with blanks (0) at front/between/back."""
    t, b = label.shape
    out = np.zeros((2 * t + 1, b), dtype=label.dtype)
    out[1::2] = label
    return out


def correct_pred(pred: np.ndarray, label: np.ndarray) -> np.ndarray:
    """pred: (T_pred, B, n_class) probabilities (exp of CTC log-probs);
    label: (T_label, B) class ids.  Returns spaced labels (T_pred, B)."""
    label_wb = interleave_blanks(label)
    t_pred, batch, _ = pred.shape
    t_lab = label_wb.shape[0]
    w = max(t_pred // 2, abs(t_pred - t_lab))

    INF = np.inf
    dtw = np.full((t_pred + 1, t_lab + 1, batch), INF, np.float32)
    dtw[0, 0] = 0.0
    # the reference pre-zeroes every row's band (hw_with_style.py:32-34);
    # cells later overwritten by the recurrence, but out-of-band reads at
    # band edges see 0, which we reproduce
    for i in range(1, t_pred + 1):
        dtw[i, max(1, i - w): min(t_lab, i + w) + 1] = 0.0
    history = np.zeros((t_pred, t_lab, batch), np.int8)
    b_idx = np.arange(batch)

    for i in range(1, t_pred + 1):
        j_lo, j_hi = max(1, i - w), min(t_lab, i + w)
        js = np.arange(j_lo, j_hi + 1)
        # cost[j, b] = 1 - p(label_wb[j-1, b]) at timestep i-1
        cost = 1.0 - pred[i - 1][b_idx[None, :], label_wb[js - 1]]
        # dtw[i, j-1] is produced within the same row: resolve sequentially
        choice = np.empty(cost.shape, np.int8)
        left = dtw[i, j_lo - 1]                      # running dtw[i, j-1]
        for idx, j in enumerate(js):
            cand = np.stack([dtw[i - 1, j], dtw[i - 1, j - 1], left])
            choice[idx] = np.argmin(cand, axis=0)
            left = cost[idx] + cand[choice[idx], b_idx]
            dtw[i, j] = left
        history[i - 1, js - 1] = choice

    spaced = np.zeros((t_pred, batch), label.dtype)
    for b in range(batch):
        i, j = t_pred - 1, t_lab - 1
        path = [label_wb[j, b]]
        while i > 0 or j > 0:
            h = history[i, j, b]
            if h == 0:
                i -= 1
            elif h == 1:
                i -= 1
                j -= 1
            else:
                j -= 1
            path.append(label_wb[j, b])
        path.reverse()
        spaced[: len(path), b] = path[:t_pred]
    return spaced
