"""Headline benchmark of the port: generated-and-recognized 64x216 word
images a second on one card: ``python -m affganwriting_torch.cli.bench
[--batch 256] [--quick]``.

The port of the JAX package's ``bench.py``.  Every image the generation
pipeline emits is also read by R (``gen/inference.py:
make_generate_and_read_fn``: one writer's style stack encoded once, a batch
of words generated, R's greedy decode over every image), at
``default_config()`` with random weights.  Stages, each at the first batch
of ``--batch`` (default 2048, 1024, 256) that runs:

- ``gen_read``: streaming (N calls dispatched back to back, one
  ``torch.cuda.synchronize()`` at the end), streaming with every image
  copied to the host (``+fetch``), and per call (synchronized, median);
- ``gen_only``: G alone, streaming and per call;
- ``gen_read_int8``: the w8a8 serving mode (``gen/inference.py:
  make_generate_and_read_quant_fn(quant_gen="static")``: R's VGG trunk and
  G's decoder convs in int8, calibrated on one generated batch), streaming;
- the merged train step (``train/step.py``) at batch 256, 64 or 8, the first
  that runs: 10 steps streamed, then per step.

``fetch_floor_ms`` is the median round trip of a trivial kernel and a
``torch.cuda.synchronize()``.  Each stage prints the whole result so far
as one JSON line, ``{"metric", "value", "unit", "vs_baseline", "extra"}``,
whose ``value`` (the streaming ``gen_read`` rate) does not change after
the first; ``vs_baseline`` is against the 5,000 images a second target of
``BASELINE.md``.  ``--headline`` picks the stage that runs first and gives
``value``: ``bf16`` (the default until the int8 mode's CER gate,
``tools/ab_int8_cer.py``, has passed on trained weights) or ``int8``.
``--quick`` stops after the headline stages (``gen_read``, and
``gen_read_int8`` with ``--headline int8``).  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

N_STREAM = 30
TARGET = 5000.0
INT8_MODE = "w8a8: R trunk + static G"
_T0 = time.perf_counter()


def _mark(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def fetch_floor_ms(iters: int = 15) -> float:
    """Median ms of one trivial kernel and ``torch.cuda.synchronize()``."""
    import torch

    x = torch.zeros((), device="cuda")
    x += 1
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        x += 1
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _setup(batch: int):
    """default_config(), one writer's style stack from seed 0 on the card,
    and ``batch`` word labels on the card."""
    import numpy as np
    import torch

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import encode_labels

    cfg = default_config()
    rng = np.random.default_rng(0)
    style = torch.as_tensor(np.asarray(
        rng.normal(size=(1, cfg.img_height, cfg.img_width, cfg.style_stack)),
        np.float32), device="cuda")
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    words = ["word" + alphabet[i % 26] + alphabet[(i // 26) % 26]
             for i in range(batch)]
    labels = torch.as_tensor(encode_labels(words, cfg.output_max_len),
                             device="cuda").long()
    return cfg, style, labels


def _rates(fn, style, labels, batch: int, images_of=None) -> dict:
    """Streaming and per-call images/s of ``fn(style, labels)``; per call
    the style moves by 1e-3 each time.  With ``images_of``, also streaming
    with ``images_of(out)`` copied to the host."""
    import torch

    from affganwriting_torch.tools.timing import wall_ms

    calls = iter(range(1, 10**6))
    per_ms = wall_ms(lambda: fn(style + next(calls) * 1e-3, labels))
    styles = [style + i * 1e-3 for i in range(N_STREAM)]
    fn(styles[0], labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(s, labels) for s in styles]
    torch.cuda.synchronize()
    out = {"stream": N_STREAM * batch / (time.perf_counter() - t0),
           "percall": batch / (per_ms / 1e3)}
    del outs
    if images_of is not None:
        t0 = time.perf_counter()
        total = 0
        for s in styles:
            host = images_of(fn(s, labels)).cpu()
            total += host.numel() * host.element_size()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["fetch_stream"] = N_STREAM * batch / dt
        out["fetch_mb_per_sec"] = total / dt / 1e6
    return out


def run_gen_read(batch: int) -> dict:
    """Generate + recognize: streaming, streaming with the images and ids
    on the host, and per call."""
    from affganwriting_torch.gen.inference import make_generate_and_read_fn

    cfg, style, labels = _setup(batch)
    fn = make_generate_and_read_fn(cfg, seed=0)

    def images_and_ids(out):
        images, ids = out
        ids.cpu()
        return images

    return _rates(fn, style, labels, batch, images_and_ids)


def run_gen_read_int8(batch: int) -> dict:
    """The w8a8 serving mode, as the JAX bench runs it: R's trunk in int8
    and G's decoder convs in static int8, both calibrated on one
    generated batch (not timed), then streaming."""
    import torch

    from affganwriting_torch.gen.inference import (
        make_generate_and_read_quant_fn,
    )

    cfg, style, labels = _setup(batch)
    fn = make_generate_and_read_quant_fn(cfg, quant_gen="static", seed=0)
    fn.calibrate(style, labels)
    styles = [style + i * 1e-3 for i in range(N_STREAM)]
    fn(styles[0], labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(s, labels) for s in styles]
    torch.cuda.synchronize()
    stream = N_STREAM * batch / (time.perf_counter() - t0)
    del outs
    return {"stream": stream}


def run_gen_only(batch: int) -> dict:
    from affganwriting_torch.gen.inference import make_generate_fn

    cfg, style, labels = _setup(batch)
    return _rates(make_generate_fn(cfg, seed=0), style, labels, batch)


def train_setup(batch: int, merge_dg: bool | None = None, device=None,
                config=None):
    """``config`` (default ``default_config()``) at ``batch``: (state, the
    phased step, merged unless ``merge_dg`` is False, a batch of seed-0
    noise on the device, a ``torch.Generator`` there seeded 1), on the
    card unless ``device="cpu"``."""
    import numpy as np
    import torch

    from affganwriting_torch.core.config import VOCAB, default_config
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    dev = resolve_device(device)
    cfg = (config or default_config()).replace(batch_size=batch)
    state = init_state(cfg, dev, seed=0)
    step = make_phased_train_step(
        cfg, merge_dg=cfg.merge_dg if merge_dg is None else merge_dg,
        device=dev)
    rng = np.random.default_rng(0)

    def lab(w):
        return VOCAB.pad_label(w, cfg.output_max_len)

    host = {
        "style_imgs": rng.normal(size=(batch, cfg.img_height, cfg.img_width,
                                       cfg.style_stack)).astype(np.float32),
        "img_xt": rng.normal(size=(batch, cfg.img_height, cfg.img_width,
                                   1)).astype(np.float32),
        "writer_ids": (np.arange(batch) % cfg.num_writers).astype(np.int32),
        "label_xt": np.asarray([lab("deep")] * batch, np.int32),
        "label_xt_swap": np.asarray([lab("dep")] * batch, np.int32),
        "label_ch0": np.asarray([lab("word")] * batch, np.int32),
    }
    # the batch lives on the card, so the upload is not timed
    batch_d = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    return state, step, batch_d, gen


def run_train_step(batch: int, n_stream: int = 10) -> dict:
    """Words trained a second through the merged four-player step:
    ``n_stream`` steps streamed, then the median of 6 synchronized steps."""
    import torch

    from affganwriting_torch.tools.timing import wall_ms

    state, step, batch_d, gen = train_setup(batch)
    step(state, batch_d, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_stream):
        step(state, batch_d, gen)
    torch.cuda.synchronize()
    stream = n_stream * batch / (time.perf_counter() - t0)
    per_ms = wall_ms(lambda: step(state, batch_d, gen), iters=6, warmup=0)
    return {"stream": stream, "percall": batch / (per_ms / 1e3)}


def _try(fn, batches):
    """``fn(b)`` at the first batch of ``batches`` that runs."""
    import torch

    for b in batches:
        try:
            _mark(f"{fn.__name__} batch {b}: setup + run")
            out = fn(b)
            _mark(f"{fn.__name__} batch {b}: done")
            return out, b
        except Exception as e:  # noqa: BLE001 -- out of memory: next batch
            print(f"bench {fn.__name__} batch {b} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            torch.cuda.empty_cache()
    return None, None


def _emit(metric: str, headline: float, extra: dict) -> dict:
    """Print the whole result so far as one JSON line and return it."""
    result = {"metric": metric, "value": round(headline, 1),
              "unit": "images/sec/chip",
              "vs_baseline": round(headline / TARGET, 3),
              "extra": dict(extra)}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=None,
                   help="one batch size (default: 2048, 1024, 256, the "
                        "first that runs)")
    p.add_argument("--quick", action="store_true",
                   help="the headline stages only")
    p.add_argument("--headline", default="bf16", choices=("bf16", "int8"))
    args = p.parse_args(argv)

    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.tools.timing import nvidia_smi_line

    resolve_device(None)
    batches = [args.batch] if args.batch else [2048, 1024, 256]
    extra = {"device": nvidia_smi_line(),
             "fetch_floor_ms": round(fetch_floor_ms(), 4),
             "n_stream": N_STREAM}
    metric = "generate+recognize 64x216 word images/sec/chip"
    headline, result = None, None

    def int8_stage():
        int8, b_q = _try(run_gen_read_int8, batches)
        if int8 is not None:
            extra.update({
                "gen_read_int8_imgs_per_sec": round(int8["stream"], 1),
                "gen_read_int8_batch": b_q, "gen_read_int8_mode": INT8_MODE})
        return int8

    # the headline's stage first, so the first line already carries it
    if args.headline == "int8":
        int8 = int8_stage()
        if int8 is not None:
            headline = int8["stream"]
            metric += " (w8a8 serving mode)"
            result = _emit(metric, headline, extra)
    res, b_used = _try(run_gen_read, batches)
    if res is not None:
        extra.update({
            "gen_read_batch": b_used,
            "gen_read_bf16_imgs_per_sec": round(res["stream"], 1),
            "gen_read_fetch_imgs_per_sec": round(res["fetch_stream"], 1),
            "gen_read_fetch_mb_per_sec": round(res["fetch_mb_per_sec"], 1),
            "gen_read_percall_imgs_per_sec": round(res["percall"], 1)})
        if headline is None:
            headline = res["stream"]
        result = _emit(metric, headline, extra)
    if headline is None:
        raise SystemExit("every headline batch size failed")
    if args.quick:
        return result
    if args.headline != "int8" and int8_stage() is not None:
        result = _emit(metric, headline, extra)
    gen_only, b_g = _try(run_gen_only, batches)
    if gen_only is not None:
        extra.update({
            "gen_only_imgs_per_sec": round(gen_only["stream"], 1),
            "gen_only_percall_imgs_per_sec": round(gen_only["percall"], 1),
            "gen_only_batch": b_g})
        result = _emit(metric, headline, extra)
    train, b_t = _try(run_train_step, [256, 64, 8])
    if train is not None:
        extra.update({
            "train_stream_imgs_per_sec": round(train["stream"], 1),
            "train_percall_imgs_per_sec": round(train["percall"], 1),
            "train_batch": b_t})
        result = _emit(metric, headline, extra)
    return result


if __name__ == "__main__":
    main()
