"""TrOCR's decoder on the device a request: the device time of the kernels
launched inside the span ``R.decode`` (the embedding, the 12 layers with
their cross attention over the encoder's tokens, and the output
projection), matched by correlation id, median over the traced requests
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
    ms = span_kernels.device_ms(ctx, lambda n: n == "R.decode")
    return ps.median(ms or [])
