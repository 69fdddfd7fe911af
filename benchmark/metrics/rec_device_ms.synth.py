"""R's device time a request: CUDA events around the recognizer's
forward (trunk, BiGRU, attention decoder), median over the window."""

import statistics

LAYER = "R: models/recognizer/"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    ms = ctx.get("spans", {}).get("rec")
    return statistics.median(ms) if ms else None
