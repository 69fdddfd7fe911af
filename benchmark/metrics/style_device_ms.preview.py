"""G's style encoder's device time a request: CUDA events around its
forward, median over the window."""

import statistics

LAYER = "G: models/generator.py, style_encoders/, decoder.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "request_p95_ms"


def read(ctx):
    ms = ctx.get("spans", {}).get("style")
    return statistics.median(ms) if ms else None
