"""G's host time a request: the span ``G``'s length on the host clock,
median over the traced requests (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "G: models/generator.py, style_encoders/, decoder.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") != "train" else None
    if prog is None:
        return None
    return ps.median(ps.host_ms(prog, ps.in_gen))
