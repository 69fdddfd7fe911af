"""Serving cells: generate-and-read requests through the port's
``make_generate_and_read_fn``, each ending with the images and the greedy
ids on the host.

A closed mix sends one request after another for the window's length and
reports the words of the requests completed inside it over its seconds.
An open mix sends each request at its due time (Poisson arrivals) and
reports the 95th percentile of due-to-done over every request due in the
window; requests still queued when it closes are served after it, up to a
minute, and one that never completes counts as missing.

The check: after the window, a sample of the finished requests drawn from
the seed (the one with the most words in it) is recomputed by the
float32 reference from the same style stacks, labels and weights: G's
images against the program's, and R, reading the program's images and fed
the program's greedy ids, against the program's per-step logits, which
R's tap (its recognizer part's ``Tap``) read in the timed calls.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import data, flops, spans, trace, traffic, weights
from benchmark.reference import models as ref

MAX_LATE_S = 60.0
NUMBERS = ("image_err", "logit_err", "token_gap", "image_rel", "logit_rel",
           "style_rel")


def program_config(cfg: dict):
    import dataclasses

    from affganwriting_torch.core.config import WordGanConfig

    fields = {f.name for f in dataclasses.fields(WordGanConfig)}
    return WordGanConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in cfg.items() if k in fields})


def make_program(cfg: dict, gen_state, rec_state, dev):
    """The system under test: the port's bf16 generate-and-read pipeline
    with the benchmark's weights."""
    from affganwriting_torch.gen.inference import make_generate_and_read_fn

    with torch.device(dev):
        return make_generate_and_read_fn(program_config(cfg), gen_state,
                                         rec_state, device=dev)


def quiet_gc() -> None:
    """Collect once and freeze what set-up made, so that the window's
    collections scan only the objects the window makes."""
    gc.collect()
    gc.freeze()


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank; a missing value is +inf."""
    v = sorted(values)
    if not v:
        return float("inf")
    return v[min(len(v) - 1, max(0, int(np.ceil(q * len(v))) - 1))]


class Server:
    def __init__(self, cell, seed, dev, build=make_program):
        self.cfg = cell["config_file"]["config"]
        self.mix = cell["traffic_mix"]
        self.dev, self.seed = dev, seed
        self.max_len = self.cfg["max_chars"] + 2
        self.vocab = data.corpus(self.cfg["max_chars"])
        self.pool = data.StylePool(seed, self.cfg, self.mix["writers"], dev)
        states = {p: weights.draw(self.cfg, p, seed, dev)
                  for p in ("gen", "rec")}
        self.run = build(self.cfg, states["gen"], states["rec"], dev)
        del states
        self.taps, self.rec_tap = [], None

    def capture(self):
        """Keep, for each request, the style encoder's taps that the
        decoder reads (3 and 4; a forward hook) and R's calls (its tap);
        returns what to remove after the window."""
        self.rec_tap = ref.tap(self.cfg, self.run.rec)
        return (self.run.gen.enc_image.register_forward_hook(
                    lambda m, a, out: self.taps.append((out[3], out[4]))),
                self.rec_tap)

    def request(self, req):
        """One request: (images (B, H, W) on the host, ids (B, steps) on
        the host, R's calls as its tap took them and style taps on the
        device)."""
        self.taps = []
        labels = data.encode_labels(req.words, self.max_len)
        imgs, ids = self.run(self.pool.stacks[req.writer:req.writer + 1],
                             labels)
        calls = self.rec_tap.take() if self.rec_tap else (lambda: [])
        return imgs[..., 0].cpu(), ids.cpu(), calls, self.taps

    def warm(self, sizes):
        for n in sizes:
            self.request(traffic.Request(-1, 0.0, 0, self.vocab[:n]))
        if self.dev.type == "cuda":
            torch.cuda.synchronize()


def serve(cell, seed: int, seconds: float, trace_path, dev, t_start: float,
          build=make_program, mutate=None, server=None) -> dict:
    """One run of a serving cell; returns the harness's result fields.
    ``mutate(outputs)`` alters a request's outputs where they are produced
    (the fault tests); ``server`` is one already built and warmed (the
    rate sweep)."""
    mix = cell["traffic_mix"]
    kind = mix["kind"]
    srv = server
    if srv is None:
        srv = Server(cell, seed, dev, build)
        srv.warm(range(mix["words_min"], mix["words_max"] + 1)
                 if kind == "open" else [mix["words_max"]])
    setup_s = time.perf_counter() - t_start
    hooks = srv.capture()
    quiet_gc()

    sp = None
    if trace_path is not None:
        sp = spans.Spans()
        g = srv.run.gen
        sp.between("style", g.enc_image)
        sp.between("gen", g.enc_image, g.dec)
        sp.between("rec", srv.run.rec)
    prof = trace.Profiled(trace_path) if trace_path is not None else None
    # the profiled stretch: whole requests in the window's last part, so
    # that the queue it slows is read before it (``queue_ms``)
    span = min(1.0 if kind == "closed" else 2.0, 0.2 * seconds)
    tr_lo, tr_hi = 0.75 * seconds, 0.75 * seconds + span
    in_trace = []

    done, attempted, failed = [], 0, 0
    latencies, queues = [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    if kind == "closed":
        reqs = traffic.closed(mix, seed, srv.vocab)
    else:
        reqs = iter(traffic.open_schedule(mix, seed, seconds, srv.vocab))
    for req in reqs:
        now = time.perf_counter()
        if kind == "closed" and now >= end:
            break
        due = t0 + req.at if kind == "open" else now
        if now < due:
            time.sleep(due - now)
        if time.perf_counter() > end + MAX_LATE_S:
            failed += 1
            attempted += 1
            latencies.append(float("inf"))
            continue
        if prof is not None and prof.prof is None \
                and time.perf_counter() - t0 >= tr_lo:
            prof.start()
        start = time.perf_counter()
        attempted += 1
        out = srv.request(req)
        if mutate is not None:
            out = mutate(out)
        fin = time.perf_counter()
        if prof is not None and prof.prof is not None and not prof.stopped:
            in_trace.append(req)
            if fin - t0 >= tr_hi:
                prof.stop(len(in_trace))
        if kind == "closed" and fin > end:
            attempted -= 1          # cut by the window's end: not counted
            break
        done.append((req, *out))
        latencies.append(fin - due)
        queues.append((start, start - due))
    if prof is not None and prof.prof is not None and not prof.stopped:
        prof.stop(len(in_trace))
    window = seconds
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    words = sum(len(r.words) for r, *_ in done)
    result = {"attempted": attempted, "failed": failed, "peak": peak,
              "e2e": {"setup_s": setup_s}}
    if kind == "closed":
        result["e2e"]["words_per_s"] = words / window
    else:
        result["e2e"]["request_p95_ms"] = 1e3 * nearest_rank(latencies, 0.95)
    result["latency_ms"] = {f"p{q}": 1e3 * nearest_rank(latencies, q / 100)
                            for q in (50, 90, 95, 99, 100)}
    if trace_path is not None:
        result["ctx"] = {
            "kind": kind, "cfg": srv.cfg, "trace": prof.trace(),
            "units": in_trace,
            "spans": {n: sp.ms(n) for n in ("style", "gen", "rec")},
            "queue_ms": [1e3 * q for t, q in queues      # before profiling
                         if prof.prof is None or t < prof.t0],
            "flops_of": lambda n, cfg=srv.cfg: flops.serve(cfg, n)}
        sp.remove()

    sample = pick_sample(done, cell["check"]["requests"], seed)
    outputs = [(r, im, ids, first_logits(calls),
                [t.float().cpu() for t in taps[0]] if taps else None)
               for r, im, ids, calls, taps in sample]
    pool = srv.pool
    del srv, server, done, sample
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["numbers"] = judge(cell["config_file"]["config"], seed, dev, pool,
                              outputs)
    return result


def first_logits(calls):
    """The per-step logits of a request's first call of R, on the host;
    None where R's tap read no call."""
    read = calls()
    return read[0][0].float().cpu() if read else None


def pick_sample(done, k: int, seed: int):
    """``k`` finished requests drawn from the seed, the longest first."""
    if not done:
        return []
    rng = np.random.default_rng([seed, 5])
    longest = max(range(len(done)), key=lambda i: len(done[i][0].words))
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    return [done[i] for i in [longest, *rest[:k - 1]]]


@torch.no_grad()
def judge(cfg: dict, seed: int, dev, pool, outputs, cast=None) -> dict:
    """The compared numbers of the sampled requests against the float32
    reference (``cast`` rounds its layers, for the control):

    - ``image_err``: the worst word's relative L2 error of its image;
    - ``logit_err``: the largest |program - reference| per-step logit over
      the reference's largest logit magnitude;
    - ``token_gap``: the widest gap by which a served id's reference logit
      lies below the reference's best at that step;
    - ``image_rel``, ``logit_rel``, ``style_rel``: the relative L2 error of
      all sampled images, of all sampled per-step logits, and of the style
      encoder's taps 3 and 4 (what the decoder reads of the style)."""
    if not outputs:
        return dict.fromkeys(NUMBERS, float("inf"))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        g, r = (weights.materialize(cfg, p, weights.draw(cfg, p, seed, dev),
                                    dev).eval() for p in ("gen", "rec"))
        if cast is not None:
            ref.set_cast(g, cast)
            ref.set_cast(r, cast)
        img_err = logit_err = gap = 0.0
        sq = dict.fromkeys(("img_d", "img_r", "lg_d", "lg_r", "st_d", "st_r"),
                           0.0)
        for req, imgs, ids, logits, taps in outputs:
            labels = torch.as_tensor(data.encode_labels(
                req.words, cfg["max_chars"] + 2), device=dev)
            style = torch.as_tensor(pool.stacks[req.writer:req.writer + 1],
                                    device=dev)
            pyramid = g.encode_style(style)
            if taps is None or logits is None:
                return dict.fromkeys(NUMBERS, float("inf"))
            for t, rt in zip(taps, (pyramid[3], pyramid[4])):
                sq["st_d"] += float((t.to(dev) - rt).square().sum())
                sq["st_r"] += float(rt.square().sum())
            x = g.generate(pyramid, labels)[:, 0]
            p = imgs.to(dev).float()
            err = ((p - x).flatten(1).norm(dim=1)
                   / x.flatten(1).norm(dim=1).clamp_min(1e-12))
            img_err = max(img_err, float(err.max()))
            sq["img_d"] += float((p - x).square().sum())
            sq["img_r"] += float(x.square().sum())
            if ids.shape != labels[:, 1:].shape:
                return dict.fromkeys(NUMBERS, float("inf"))
            ids = ids.to(dev)
            rl = r(p[:, None], labels, feed=ids)
            d = logits.to(dev) - rl
            logit_err = max(logit_err, float(d.abs().max() / rl.abs().max()))
            sq["lg_d"] += float(d.square().sum())
            sq["lg_r"] += float(rl.square().sum())
            served = rl.gather(-1, ids[..., None])[..., 0]
            gap = max(gap, float((rl.max(-1).values - served).max()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"image_err": img_err, "logit_err": logit_err, "token_gap": gap,
            "image_rel": (sq["img_d"] / max(sq["img_r"], 1e-30)) ** 0.5,
            "logit_rel": (sq["lg_d"] / max(sq["lg_r"], 1e-30)) ** 0.5,
            "style_rel": (sq["st_d"] / max(sq["st_r"], 1e-30)) ** 0.5}
