"""The device's idle share of the traced stretch: 1 - the union of its
kernel, copy and set intervals over the stretch's host-clock length,
the mean over the cards."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_words_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    busy = ctx.get("busy_each") or [tr.busy_s]
    window = ctx.get("window_each") or [tr.window_s]
    return 100.0 * (1.0 - sum(b / w for b, w in zip(busy, window))
                    / len(busy))
