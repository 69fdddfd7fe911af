"""The device's idle time put down to R a request: each idle gap of the
traced stretch to the innermost program span open as it began, summed
over ``R`` and its children, over the traced requests
(``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "R: models/recognizer/"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") != "train" else None
    if prog is None:
        return None
    return ps.mean(ps.idle_ms(prog, ps.in_rec))
