"""G's device time a request: CUDA events from the start of the style
encoder's forward to the end of the decoder's, median over the window."""

import statistics

LAYER = "G: models/generator.py, style_encoders/, decoder.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    ms = ctx.get("spans", {}).get("gen")
    return statistics.median(ms) if ms else None
