"""``phase_head``'s share of its roofline: the least time of the
operation's work (the unpadded phase tensor, the 7x7 weights and the bias
read once, the image written once, bf16; 2 x 49 x C FLOPs a pixel) over
the kernel's time in the traced requests, by kernel name.  A kernel that
fuses the reflect pad is judged on the same work."""

from benchmark.harness import work

LAYER = "kernels: csrc/in_relu.cu, csrc/phase_head.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("kind") == "train":
        return None
    secs = tr.kernel_s(lambda n: "phase_head" in n)
    if secs <= 0:
        return None
    f = b = 0.0
    for req in ctx["units"]:
        shape = work.decoder_shapes(ctx["cfg"], len(req.words))["phase_head"]
        df, db = work.phase_head_work(shape)
        f, b = f + df, b + db
    return work.roofline_share(f, b, secs, ctx["peaks"])
