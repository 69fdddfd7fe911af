"""Kernels launched a step in the phases' backwards: the host launches
inside the spans ``step.<phase>.bwd``, from any host thread (the
autograd engine's), over the traced steps (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "train backward: autograd from train/step.py"
UNIT = "count"
SOURCE = "program_span"
MOVES = "train_words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") == "train" else None
    if prog is None:
        return None
    return ps.mean(ps.launches(prog, ps.step_part("bwd")))
