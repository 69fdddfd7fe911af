"""TrOCR's encoder on the device a request: the device time of the kernels
launched inside the span ``R.encode`` (the ViT over 577 tokens a word),
matched by correlation id, median over the traced requests
(``harness/span_kernels.py``)."""

from benchmark.harness import program_spans as ps
from benchmark.harness import span_kernels

LAYER = "R (TrOCR): models/recognizer/trocr.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    if ctx.get("kind") == "train" or ctx.get("trace") is None:
        return None
    ms = span_kernels.device_ms(ctx, lambda n: n == "R.encode")
    return ps.median(ms or [])
