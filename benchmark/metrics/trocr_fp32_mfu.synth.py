"""TrOCR's R against the card's float32 peak: the reference R's FLOPs of
the traced requests (``FlopCounterMode`` on the meta device, as
``harness/flops.py`` counts them) over the device time of the kernels
launched inside the span ``R`` and its children (matched by correlation
id, ``harness/span_kernels.py``), over the card's dense float32 (non-tensor)
peak.  TrOCR runs in float32 whatever ``compute_dtype`` says, and the
cell's logit limits keep it there, so the bf16 peak that ``mfu.synth``
divides by is out of its reach.  Reads nothing for another recognizer."""

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import program_spans as ps
from benchmark.harness import span_kernels, work
from benchmark.reference import models as ref

LAYER = "R (TrOCR): models/recognizer/trocr.py"
UNIT = "%"
SOURCE = "program_span"
MOVES = "words_per_s"

# NVIDIA's H100 data sheet, FP32 (non-tensor) FLOP/s, by the part that
# ``work.card_peaks`` picks from the card's name
FP32_PEAKS = {work.CARD_PEAKS[part]: peak for part, peak in
              (("PCIe", 51e12), ("NVL", 60e12), ("SXM", 67e12))}


@functools.lru_cache(maxsize=8)
def _rec_flops(cfg_key: str, words: int) -> float:
    cfg = json.loads(cfg_key)
    with torch.device("meta"):
        rec = ref.build(cfg, "rec").eval()
    labels = torch.zeros(words, cfg["max_chars"] + 2, dtype=torch.long,
                         device="meta")
    img = torch.empty(words, 1, cfg["img_height"], cfg["img_width"],
                      device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rec(img, labels, feed=labels[:, 1:])
    return float(fc.get_total_flops())


def rec_flops(cfg: dict, words: int) -> float:
    """FLOPs of the reference R reading ``words`` words back."""
    return _rec_flops(json.dumps(cfg, sort_keys=True), words)


def read(ctx):
    cfg = ctx.get("cfg") or {}
    if (ctx.get("kind") == "train" or ctx.get("trace") is None
            or cfg.get("recognizer") != "trocr"):
        return None
    ms = span_kernels.device_ms(ctx, ps.in_rec)
    units = ctx.get("units") or []
    if not ms or len(ms) != len(units) or sum(ms) <= 0:
        return None
    flops = sum(rec_flops(cfg, len(u.words)) for u in units)
    return 100.0 * flops / (sum(ms) / 1e3 * FP32_PEAKS[tuple(ctx["peaks"])])
