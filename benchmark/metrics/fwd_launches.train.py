"""Kernels launched a step in the phases' forwards and losses: the host
launches inside the spans ``step.<phase>.fwd``, from any host thread,
over the traced steps (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "train forward: train/step.py, train/losses.py, models/"
UNIT = "count"
SOURCE = "program_span"
MOVES = "train_words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") == "train" else None
    if prog is None:
        return None
    return ps.mean(ps.launches(prog, ps.step_part("fwd")))
