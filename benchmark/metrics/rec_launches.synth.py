"""Kernels launched inside R a request: the host launches of the traced
stretch inside the span ``R`` or its children, over the traced requests
(``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "R: models/recognizer/"
UNIT = "count"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") != "train" else None
    if prog is None:
        return None
    return ps.mean(ps.launches(prog, ps.in_rec))
