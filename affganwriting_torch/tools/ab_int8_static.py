"""A/B of the w8a8 serving mode on the card: G alone in bf16, dynamic int8
and static int8, then the pipeline in bf16, with R's trunk in int8 (G
bf16), and with R's trunk in int8 and G in dynamic or static int8, all in
one process on the same models.

    python3 -m affganwriting_torch.tools.ab_int8_static [--batch 256]

The port of ``scripts/ab_int8_static.py``: ``default_config()`` with
random weights from seed 0, one writer's style stack, calibration on one
generated batch (``make_generate_and_read_quant_fn(...).calibrate``), each
variant streamed over ``cli/bench``'s N calls with one
``torch.cuda.synchronize()`` at the end.  Prints one JSON line a variant,
``vs_bf16`` against the bf16 variant of its kind, and returns them.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import time


def stream_rate(fn, styles, labels, batch: int) -> float:
    """Images a second of ``fn(style, labels)`` streamed over ``styles``
    (after one warm call)."""
    import torch

    fn(styles[0], labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(s, labels) for s in styles]
    torch.cuda.synchronize()
    del outs
    return len(styles) * batch / (time.perf_counter() - t0)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args(argv)

    from affganwriting_torch.cli.bench import N_STREAM, _setup
    from affganwriting_torch.gen.inference import (
        gen_fn_in_mode,
        make_generate_and_read_quant_fn,
        resolve_device,
    )

    dev = resolve_device(None)
    cfg, style, labels = _setup(args.batch)
    run = make_generate_and_read_quant_fn(cfg, quant_gen="static", seed=0)
    run.calibrate(style, labels)
    styles = [style + i * 1e-3 for i in range(N_STREAM)]
    gens = {m: gen_fn_in_mode(run.gen, m, dev)
            for m in (None, "dynamic", "static")}

    def pipe(mode, int8_r):
        def fn(s, lab):
            images = gens[mode](s, lab)
            return images, (run.run_rec if int8_r else run.base.run_rec)(
                images, lab)
        return fn

    variants = {
        "gen_bf16": gens[None],
        "gen_int8_dynamic": gens["dynamic"],
        "gen_int8_static": gens["static"],
        "pipe_bf16": pipe(None, False),
        "pipe_int8R": pipe(None, True),
        "pipe_int8R_dynamicG": pipe("dynamic", True),
        "pipe_int8R_staticG": pipe("static", True),
    }
    rates = {k: stream_rate(fn, styles, labels, args.batch)
             for k, fn in variants.items()}
    lines = []
    for k, v in rates.items():
        ref = rates["gen_bf16" if k.startswith("gen") else "pipe_bf16"]
        lines.append({"variant": k, "batch": args.batch,
                      "imgs_per_sec": round(v, 1),
                      "vs_bf16": round(v / ref, 3)})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
