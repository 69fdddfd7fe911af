"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and a control's, in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 4 [--control fp8|w8a8]

Two controls: ``w8a8``, the program's own lower-precision serving path
(``make_generate_and_read_quant_fn``: R's trunk and G's decoder convs in
int8, static scales calibrated on the first request), and ``fp8``, the
float32 reference put in the program's place with every convolution and
dense layer rounded to float8 e4m3 (serving and training).  Each seed
prints one JSON line ``{"workload", "seed", "control", "numbers"}``; the
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import data, spec, traffic, weights  # noqa: E402
from benchmark.harness import serve as S  # noqa: E402
from benchmark.harness import train as T  # noqa: E402
from benchmark.reference import models as ref  # noqa: E402
from benchmark.reference import step as rstep  # noqa: E402


def make_w8a8_program(cfg: dict, gen_state, rec_state, dev):
    """The program in its w8a8 serving mode: G's decoder convs and R's
    trunk in int8, static scales from the first request it serves."""
    from affganwriting_torch.gen.inference import (
        make_generate_and_read_quant_fn,
    )

    with torch.device(dev):
        q = make_generate_and_read_quant_fn(
            S.program_config(cfg), gen_state, rec_state, quant_gen="static",
            device=dev)

    def run(style, labels):
        if q.qparams is None:
            q.calibrate(style, labels)
        return q(style, labels)

    run.gen, run.rec = q.gen, q.rec
    return run


def make_fp8_program(cfg: dict, gen_state, rec_state, dev):
    """The float32 reference in the program's place, its layers rounded
    to float8 e4m3: ``run(style, labels) -> (images, greedy ids)``."""
    g = ref.set_cast(weights.materialize(cfg, "gen", gen_state, dev).eval(),
                     ref.fp8_round)
    r = ref.set_cast(weights.materialize(cfg, "rec", rec_state, dev).eval(),
                     ref.fp8_round)

    @torch.no_grad()
    def run(style, labels):
        style = torch.as_tensor(style, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        x = g.generate(g.encode_style(style), labels)
        logits = r(x, labels)
        return x.permute(0, 2, 3, 1), logits.argmax(-1)

    run.gen, run.rec = g, r
    return run


CONTROLS = {"w8a8": make_w8a8_program, "fp8": make_fp8_program}


def control_train(cell, seed: int, dev, cast=ref.fp8_round) -> dict:
    """The reference in the program's place, rounded to float8, through
    the checked steps; its readings judged as the program's are."""
    cfg, mix = cell["config_file"]["config"], cell["traffic_mix"]
    pool = data.StylePool(seed, cfg, mix["writers"], dev)
    batches = traffic.train_batches(mix, seed, pool,
                                    data.corpus(cfg["max_chars"]), cfg)
    checked = [next(batches) for _ in range(T.CHECK_STEPS)]
    init = {p: weights.draw(cfg, p, seed, dev) for p in rstep.PLAYERS}
    models = {p: ref.set_cast(weights.materialize(cfg, p, init[p], dev),
                              cast) for p in rstep.PLAYERS}
    opts = rstep.make_opts(models, cfg)
    gen = torch.Generator(device=dev).manual_seed(T.dropout_seed(seed))
    tap = T.IdTap(models["rec"], cfg)
    firsts = T.FirstOutputs(models, cfg)
    prog = {"loss": []}
    for k, b in enumerate(checked):
        losses = rstep.step(models, opts, T.device_batch(b, dev), gen, cfg,
                            (None, None, None))
        prog["loss"].append({n: float(v) for n, v in losses.items()})
        if k == 0:
            prog["first"] = {n: v.cpu() for n, v in firsts.close().items()}
            prog["grad"] = {f"{n}.{name}": float(m.norm() / (1 - T.BETA1))
                            for n, opt in opts.items()
                            for (name, _), m in zip(
                                models[n].named_parameters(), opt.m)}
    tap.close()
    prog["delta"] = T.changes(models, init)
    prog["feeds"] = [tuple(f.cpu() for f in tap.feeds(k))
                     for k in range(T.CHECK_STEPS)]
    del models, opts, init
    return T.judge(cfg, seed, dev, checked, prog)


def readings(cell, seed: int, seconds: float, control, dev) -> dict:
    """The compared numbers of one seed: the program's (``control`` None),
    or a control's (``"fp8"``; serving also ``"w8a8"``)."""
    kind = cell["traffic_mix"]["kind"]
    t0 = time.perf_counter()
    if kind == "train":
        if control:
            return control_train(cell, seed, dev)
        return T.train(cell, seed, seconds, None, dev, t0)["numbers"]
    build = CONTROLS[control] if control else S.make_program
    return S.serve(cell, seed, seconds, None, dev, t0, build=build)["numbers"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", choices=sorted(CONTROLS), default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(cell, seed, args.seconds, args.control, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "numbers": nums}),
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
