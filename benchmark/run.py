"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
also printed as the last lines of standard error.  Exits non-zero, printing
no result, without a CUDA card, with fewer cards than the cell asks for,
or when JAX or the JAX package was loaded.  A cell on several cards starts
one process a card (``harness/multi.py``); rank 0 prints the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# caches of the program stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "affganwriting_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names, compared whole, of loaded modules the port must
    not pull in."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def per_layer(cell: dict, e2e: str, ctx: dict) -> dict:
    from benchmark.harness import spec

    out = {}
    for name, mod in spec.metrics_of(cell["name"], e2e).items():
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def result_line(cell, res, trace: bool, device: dict) -> dict:
    from benchmark.harness import traffic
    from benchmark.harness.checks import checks_of, is_correct

    checks = checks_of(res["numbers"], cell["check"]["limits"])
    e2e = traffic.E2E[cell["traffic_mix"]["kind"]]
    units = {"setup_s": "s", "words_per_s": "words/s",
             "request_p95_ms": "ms", "train_words_per_s": "words/s"}
    if trace:
        ctx = dict(res["ctx"], peaks=device["peaks"], cell=cell)
        metrics = per_layer(cell, e2e, ctx)
        tr = ctx["trace"]
        busy = ctx.get("busy_each") or [tr.busy_s if tr else 0.0]
        window = ctx.get("window_each") or [tr.window_s if tr else 0.0]
        device = dict(device, busy_s=sum(busy) / len(busy),
                      window_s=sum(window) / len(window))
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in res["e2e"].items()}
    device.pop("peaks")
    line = {"correct": is_correct(checks) and res["failed"] == 0,
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace and res["ctx"]["trace"] is not None:
        tr = res["ctx"]["trace"]
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    chips = cell["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if chips > 1 and args.rank is None:
        from benchmark.harness import multi
        return multi.launch(args, chips)

    from benchmark.harness import work

    torch.set_num_threads(1)
    kind = cell["traffic_mix"]["kind"]
    rank = "" if args.rank is None else f".rank{args.rank}"
    trace_path = (ROOT / "build" / "bench_traces" /
                  f"{args.workload}{rank}.json" if args.trace else None)
    mesh = None
    if chips > 1:
        from benchmark.harness import multi
        mesh = multi.join(args, chips)
    dev = torch.device("cuda", torch.cuda.current_device())
    if kind == "train":
        from benchmark.harness.train import train
        res = train(cell, args.seed, args.seconds, trace_path, dev, T_START,
                    mesh=mesh)
    else:
        from benchmark.harness.serve import serve
        res = serve(cell, args.seed, args.seconds, trace_path, dev, T_START)
    if mesh is not None:
        res = multi.gather(res, mesh)
        if mesh.data_rank != 0:
            multi.leave()
            return 0
    found = forbidden_modules()
    if found:
        print(f"loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    name = torch.cuda.get_device_name(dev)
    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": res["peak"], "peaks": work.card_peaks(name),
              "power": work.power_limit()}
    line = result_line(cell, res, bool(args.trace), device)
    if args.trace:      # the tracing's cost: the traced run's own window
        print(f"traced end_to_end {json.dumps(res['e2e'])}", file=sys.stderr)
    if "latency_ms" in res:
        print(f"latency {json.dumps(res['latency_ms'])}", file=sys.stderr)
    print(f"readings {json.dumps(res['numbers'])}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    if mesh is not None:
        multi.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
