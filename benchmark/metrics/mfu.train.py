"""The whole step's share of the cards' dense bf16 peak: the reference
step's FLOPs (forward and backward of the four players at the global
batch) times the traced steps, over the traced seconds times the cards."""

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("units") or ctx.get("kind") != "train":
        return None
    f = ctx["flops_of"](ctx["batch"]) * ctx["units"]
    return 100.0 * f / (tr.window_s * ctx["chips"] * ctx["peaks"][1])
