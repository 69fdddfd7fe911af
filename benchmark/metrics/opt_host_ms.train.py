"""Host time a step in the phases' optimizer steps: the spans
``step.<phase>.opt`` summed on the host clock in each traced step,
median over the steps (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "optimizer: train/state.py make_optimizers, torch Adam"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") == "train" else None
    if prog is None:
        return None
    return ps.median(ps.host_ms(prog, ps.step_part("opt")))
