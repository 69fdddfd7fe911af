"""Kernels launched a step in the phases' optimizer steps: the host
launches inside the spans ``step.<phase>.opt``, from any host thread,
over the traced steps (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "optimizer: train/state.py make_optimizers, torch Adam"
UNIT = "count"
SOURCE = "program_span"
MOVES = "train_words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") == "train" else None
    if prog is None:
        return None
    return ps.mean(ps.launches(prog, ps.step_part("opt")))
