"""Stage-split profiling of the generate-and-read pipeline on the card:
``python -m affganwriting_torch.cli.profile_pipeline --batch 2048``.

The port of ``affganwriting_tpu/cli/profile_pipeline.py``: each stage of
the headline pipeline at ``default_config()`` with random weights, timed
streaming (``--n-stream`` calls dispatched back to back, ended by one
``torch.cuda.synchronize()``; ``utils/profiling.stream_ms``), with its
FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` and its bytes from
``utils/profiling.ByteCounter`` (each aten op's operands and results: a
no-fusion upper bound, ``gbytes_is`` says so) counted on one more call,
plus what the CUDA kernels launched in it report
(``utils/profiling.op_counts``).
``mfu`` and ``hbm_frac`` are against the card's peaks from its name
(``tools/timing.card_peaks``: the H100 SXM's 989 TFLOP/s dense bf16 and
3.35 TB/s, the PCIe and NVL parts by name); a ``--device cpu`` run has no
peaks and prints them as null.

Stages:
  style_encode   ResNet50 over the (1, 64, 216, 50) style stack
  generate       style pyramid + labels -> (B, 1, 64, 216) images (G half;
                 in eval mode, so on the card it launches ``in_relu`` twice
                 and ``phase_head`` once)
  rec_full       images -> per-step logits (R half: VGG + BiGRU + decoder)
  rec_trunk      R's VGG19-BN trunk only
  rec_encoder    trunk + BiGRU (decoder cost = rec_full - rec_encoder)
  train_step     the merged four-player step at ``--train-batch``
                 (``cli/bench.train_setup``, as the JAX CLI builds on
                 ``bench._train_setup``)
  train_phases   only when named in ``--stages``: per phase of the 4-phase
                 step (rec, cla, dis, gen) and the merged one's dis_gen,
                 each phase ended by a synchronize, then a TOTAL line

Prints one JSON line per stage, with the JAX CLI's keys and ``device``.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

from affganwriting_torch.core.config import default_config


def _phase_clock(device, marks: dict):
    """An ``on_phase`` callback adding each phase's synchronized seconds
    to ``marks``."""
    import time

    from affganwriting_torch.utils.profiling import sync

    last = [time.perf_counter()]

    def on_phase(name: str) -> None:
        sync(device)
        now = time.perf_counter()
        marks[name] = marks.get(name, 0.0) + now - last[0]
        last[0] = now

    def start() -> None:
        sync(device)
        last[0] = time.perf_counter()

    return on_phase, start


def _phase_counts(step, state, batch_d, gen) -> dict:
    """{phase: {flops, bytes}} of one step, each phase's share read off
    the running counts at its ``on_phase`` mark."""
    from torch.utils.flop_counter import FlopCounterMode

    from affganwriting_torch.utils.profiling import ByteCounter

    out, seen = {}, [0.0, 0.0]
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        def on_phase(name: str) -> None:
            now = [float(flops.get_total_flops()), float(nbytes.bytes)]
            out[name] = {"flops": now[0] - seen[0],
                         "bytes": now[1] - seen[1]}
            seen[:] = now

        step(state, batch_d, gen, on_phase)
    return out


def train_phases(cfg, tb: int, n_stream: int, device, peaks) -> list[dict]:
    """The per-phase rows and the TOTAL row: the 4-phase step for rec,
    cla, dis and gen, the merged step for dis_gen."""
    from affganwriting_torch.cli.bench import train_setup
    from affganwriting_torch.utils.profiling import stage_row

    rows, report = [], {}
    for merge in (False, True):
        state, step, batch_d, gen = train_setup(tb, merge_dg=merge,
                                                device=device, config=cfg)
        counts = _phase_counts(step, state, batch_d, gen)
        marks: dict = {}
        on_phase, start = _phase_clock(device, marks)
        start()
        for _ in range(n_stream):
            step(state, batch_d, gen, on_phase)
        for name, sec in marks.items():
            if merge and name != "dis_gen":
                continue
            report[name] = 1e3 * sec / n_stream
            rows.append((name, counts[name]))
        del state, step
    out = [stage_row(f"train_phase/{name}", report[name], c, peaks,
                     batch=tb) for name, c in rows]
    four = sum(report[k] for k in ("rec", "cla", "dis", "gen"))
    three = report["rec"] + report["cla"] + report["dis_gen"]
    out.append({"stage": "train_phase/TOTAL", "batch": tb,
                "four_program_ms": round(four, 3),
                "merged_dg_ms": round(three, 3),
                "merged_speedup": round(four / three, 3)})
    return out


def main(argv=None):
    """Profile; returns the printed rows."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--n-stream", type=int, default=30)
    p.add_argument("--train-batch", type=int, default=64)
    p.add_argument("--stages", default=None,
                   help="comma list to restrict (default: all but "
                        "train_phases)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from affganwriting_torch.cli.bench import train_setup
    from affganwriting_torch.gen.inference import (
        build_models,
        encode_labels,
        resolve_device,
    )
    from affganwriting_torch.utils.profiling import (
        device_peaks,
        op_counts,
        stage_row,
        stream_ms,
    )

    dev = resolve_device(args.device)
    card, peaks = device_peaks(dev)
    cfg = default_config()
    gen, rec = build_models(cfg, dev, seed=0)
    b = args.batch
    rng = np.random.default_rng(0)
    only = set(args.stages.split(",")) if args.stages else None
    rows = []

    def emit(row: dict) -> None:
        row["device"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    style = torch.as_tensor(rng.normal(size=(
        1, cfg.img_height, cfg.img_width, cfg.style_stack)).astype(
            np.float32), device=dev)
    words = ["profile", "pipeline", "streaming", "measure"] * (b // 4 + 1)
    labels = torch.as_tensor(encode_labels(words[:b], cfg.output_max_len),
                             device=dev).long()

    if only is None or "train_step" in only:
        tb = args.train_batch
        state, step, batch_d, tgen = train_setup(tb, device=dev, config=cfg)
        ms = stream_ms(lambda: step(state, batch_d, tgen), (), (),
                       args.n_stream, dev)
        counts = op_counts(step, state, batch_d, tgen)
        emit(stage_row("train_step", ms, counts, peaks, batch=tb,
                       imgs_per_sec=round(tb / (ms / 1e3), 1)))
        del state, step, batch_d

    if only is not None and "train_phases" in only:
        for row in train_phases(cfg, args.train_batch, args.n_stream, dev,
                                peaks):
            emit(row)

    with torch.inference_mode():
        pyramid = gen.encode_style(style)
        images = gen.generate(pyramid, labels)
        stages = {
            "style_encode": (gen.encode_style, (style,), (style + 0.01,), 1),
            "generate": (gen.generate, (pyramid, labels),
                         (pyramid, labels.roll(1, 0)), b),
            "rec_full": (rec, (images, labels),
                         (images + 0.01, labels.roll(1, 0)), b),
            "rec_trunk": (lambda im: rec.enc.vgg(im.expand(-1, 3, -1, -1)),
                          (images,), (images + 0.01,), b),
            "rec_encoder": (rec.enc, (images,), (images + 0.01,), b),
        }
        for name, (fn, a, bb, denom) in stages.items():
            if only and name not in only:
                continue
            ms = stream_ms(fn, a, bb, args.n_stream, dev)
            counts = op_counts(fn, *a)
            emit(stage_row(name, ms, counts, peaks,
                           imgs_per_sec=round(denom / (ms / 1e3), 1)))
    return rows


if __name__ == "__main__":
    main()
