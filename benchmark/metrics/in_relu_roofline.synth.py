"""``in_relu``'s share of its roofline: the least time of the operation's
work (x read once, y written once, bf16) over the kernel's time in the
traced requests, by kernel name."""

from benchmark.harness import work

LAYER = "kernels: csrc/in_relu.cu, csrc/phase_head.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("kind") == "train":
        return None
    secs = tr.kernel_s(lambda n: "in_relu" in n)
    if secs <= 0:
        return None
    f = b = 0.0
    for req in ctx["units"]:
        shapes = work.decoder_shapes(ctx["cfg"], len(req.words))["in_relu"]
        for shape in shapes:
            df, db = work.in_relu_work(shape)
            f, b = f + df, b + db
    return work.roofline_share(f, b, secs, ctx["peaks"])
