"""FLOPs of the work, counted by ``FlopCounterMode`` on the float32
reference at the cell's shapes, on the meta device (nothing is computed):
the matrix products and convolutions of the forward pass, and of the
backward pass for the train step.  The GRUs' recurrences count as the
products they decompose into."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models as ref
from benchmark.reference import step as rstep


def _build(cfg_key, player):
    with torch.device("meta"):
        return ref.build(json.loads(cfg_key), player)


@functools.lru_cache(maxsize=16)
def _serve(cfg_key: str, words: int) -> float:
    cfg = json.loads(cfg_key)
    g, r = _build(cfg_key, "gen").eval(), _build(cfg_key, "rec").eval()
    t = cfg["max_chars"] + 2
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        style = torch.empty(1, cfg["img_height"], cfg["img_width"],
                            cfg["style_stack"], device="meta")
        labels = torch.zeros(words, t, dtype=torch.long, device="meta")
        x = g.generate(g.encode_style(style), labels)
        r(x, labels, feed=labels[:, 1:])
    return float(fc.get_total_flops())


def serve(cfg: dict, words: int) -> float:
    """FLOPs of one request: one style stack encoded, ``words`` words
    generated and read back."""
    return _serve(json.dumps(cfg, sort_keys=True), words)


@functools.lru_cache(maxsize=16)
def _train(cfg_key: str, batch: int) -> float:
    cfg = json.loads(cfg_key)
    models = {n: _build(cfg_key, n) for n in rstep.PLAYERS}
    opts = rstep.make_opts(models, cfg)
    h, w, t = cfg["img_height"], cfg["img_width"], cfg["max_chars"] + 2
    img = torch.empty(batch, 1, h, w, device="meta")
    lab = torch.zeros(batch, t, dtype=torch.long, device="meta")
    b = {"style": torch.empty(batch, h, w, cfg["style_stack"], device="meta"),
         "img_ch0": img, "img_ch1": img, "label_ch0": lab, "label_xt": lab,
         "label_xt_swap": lab,
         "writer_ids": torch.zeros(batch, dtype=torch.long, device="meta")}
    feed = lab[:, 1:]
    with FlopCounterMode(display=False) as fc:
        rstep.step(models, opts, b, None, cfg, (feed, feed, feed))
    return float(fc.get_total_flops())


def train(cfg: dict, batch: int) -> float:
    """FLOPs of one merged step (forward and backward of all four players)
    at ``batch`` rows."""
    return _train(json.dumps(cfg, sort_keys=True), batch)
