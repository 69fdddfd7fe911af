"""The share of traced requests whose decoder replayed a captured CUDA
graph: requests whose ``G.dec`` span holds a ``G.dec.replay`` span, in
percent of the traced requests (``harness/program_spans.py``).  A trace
without program spans reads as no number; one whose requests replay
nothing reads 0."""

from benchmark.harness import program_spans as ps

LAYER = "G: models/generator.py, style_encoders/, decoder.py"
UNIT = "%"
SOURCE = "program_span"
MOVES = "words_per_s"


def replayed(spans) -> bool:
    decs = [(s, e) for s, e, n in spans if n == "G.dec"]
    return any(s0 <= s and e <= e0 for s, e, n in spans
               if n == "G.dec.replay" for s0, e0 in decs)


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") != "train" else None
    if prog is None:
        return None
    tree = ps.Tree(prog)
    if not tree.tops:
        return None
    return 100.0 * sum(map(replayed, tree.inside)) / len(tree.tops)
