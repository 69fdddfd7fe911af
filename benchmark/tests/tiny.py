"""Cells of the benchmark cut to a size the CPU runs in seconds: the
published geometry (64 x 216 words, 6-layer D and C) with narrow widths."""

from benchmark.harness import spec

TINY = dict(style_dim=64, adain_param_dim=512, rec_hidden=32,
            num_writers=10, style_stack=4)


def tiny_cell(name: str, **mix) -> dict:
    c = spec.cell(name)
    c["config_file"]["config"].update(TINY)
    c["traffic_mix"].update(mix)
    if "requests" in c["check"]:
        c["check"]["requests"] = 2
    return c


def synth(**kw):
    return tiny_cell("word-resnet50.synth-bulk", writers=3, words_min=4,
                     words_max=4, **kw)


def preview(**kw):
    return tiny_cell("word-dinov2l.preview", writers=3, words_max=3,
                     rate_per_s=2.0, **kw)


def train(**kw):
    return tiny_cell("word-resnet50.train-b8", writers=4, batch=4, **kw)
