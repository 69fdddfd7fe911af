"""The whole request's share of the card's dense bf16 peak: FLOPs of the
traced requests (the reference's count at their shapes) over the traced
stretch's seconds."""

LAYER = "whole request"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("units") or ctx.get("kind") == "train":
        return None
    f = sum(ctx["flops_of"](len(r.words)) for r in ctx["units"])
    return 100.0 * f / (tr.window_s * ctx["peaks"][1])
