"""Host time a step in the phases' forwards and losses: the spans
``step.<phase>.fwd`` summed on the host clock in each traced step,
median over the steps (``harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

LAYER = "train forward: train/step.py, train/losses.py, models/"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_words_per_s"


def read(ctx):
    prog = ps.of(ctx) if ctx.get("kind") == "train" else None
    if prog is None:
        return None
    return ps.median(ps.host_ms(prog, ps.step_part("fwd")))
