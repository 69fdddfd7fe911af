"""NCCL's kernel time a step on one card: the device trace's kernels whose
name holds ``nccl`` over the traced steps."""

LAYER = "multi-device: parallel/"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("units"):
        return None
    secs = tr.kernel_s(lambda n: "nccl" in n.lower())
    if secs <= 0:
        return None
    return 1e3 * secs / ctx["units"]
