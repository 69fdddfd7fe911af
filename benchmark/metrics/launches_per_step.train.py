"""Kernels launched a train step: the device trace's kernels over the
traced steps (one card's)."""

LAYER = "train step: train/step.py, train/state.py"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "train_words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("units"):
        return None
    return tr.kernel_count() / ctx["units"]
