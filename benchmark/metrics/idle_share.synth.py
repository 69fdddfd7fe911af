"""The device's idle share of the traced stretch: 1 - the union of its
kernel, copy and set intervals over the stretch's host-clock length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
