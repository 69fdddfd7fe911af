"""Evaluation step: both target words generated in eval mode and scored.

Port of ``affganwriting_tpu/train/eval_step.py``: G generates the pair from
the style stack with its running statistics, D, C and R score the fakes
(R without dropout, decoding greedily), and the step returns the losses,
R's greedy predictions for the CER accumulators and the images.  On the
card each ``generate`` runs the ``in_relu`` kernel twice and ``phase_head``
once, inside the decoder's CUDA graph (``utils/cuda_graphs.py``): G stays
in eval mode across steps, so a step after the first replays the encoder's
and the decoder's graphs.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.parallel.ops import reduce_values
from affganwriting_torch.train import losses
from affganwriting_torch.train.state import WordGanState
from affganwriting_torch.train.step import (
    generate_pair,
    to_device_batch,
    to_nhwc,
)


def make_eval_step(config: WordGanConfig, *, device=None, mesh=None):
    """Returns ``eval_step(state, batch) -> (metrics, preds, images)``:
    metrics ``l_dis``, ``l_cla``, ``l_rec``; preds ``pred_xt``,
    ``pred_swap`` (B, T - 1); images ``xg``, ``xg_swap`` (B, H, W, 1).
    ``batch`` is the train step's without ``label_ch0``.  Leaves the
    players in eval mode.  Runs on the card unless ``device="cpu"``.
    With ``mesh`` (``train/step.py``'s rules) ``batch`` is this rank's
    slice, the metrics are the global batch's and the predictions and
    images this rank's rows."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    ls = config.label_smoothing
    n_data = 1 if mesh is None else mesh.data

    @torch.inference_mode()
    def eval_step(state: WordGanState, batch: Mapping):
        gen, dis, cla, rec = (getattr(state, n).model.eval()
                              for n in ("gen", "dis", "cla", "rec"))
        b = to_device_batch(batch, dev)
        label_xt, label_swap = b["label_xt"], b["label_xt_swap"]
        xg, xg_swap = generate_pair(gen, b["style"], label_xt, label_swap)
        logits_xt, _ = rec(xg, label_xt)
        logits_swap, _ = rec(xg_swap, label_swap)
        wid = b["writer_ids"]
        # the means' parts of the global means (R's loss is a sum)
        metrics = {
            "l_dis": 0.5 * (losses.gen_adv_loss(dis(xg))
                            + losses.gen_adv_loss(dis(xg_swap))) / n_data,
            "l_cla": 0.5 * (losses.writer_ce_loss(cla(xg), wid)
                            + losses.writer_ce_loss(cla(xg_swap), wid))
            / n_data,
            "l_rec": 0.5 * (losses.rec_loss(logits_xt, label_xt, ls)
                            + losses.rec_loss(logits_swap, label_swap, ls)),
        }
        if n_data > 1:
            metrics = reduce_values(metrics, mesh.data_group)
        preds = {"pred_xt": logits_xt.argmax(-1),
                 "pred_swap": logits_swap.argmax(-1)}
        return metrics, preds, {"xg": to_nhwc(xg), "xg_swap": to_nhwc(xg_swap)}

    return eval_step
