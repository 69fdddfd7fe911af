"""The one-off rate sweep of an open-loop cell: the highest Poisson rate
the program sustains without a growing backlog (the knee), and the cell's
rate at four fifths of it.

    python benchmark/sweep_preview.py --workload word-dinov2l.preview \\
        --rates 10,20,40,60,80 --seconds 20 --seed 7

One program is built and warmed; each rate runs a window of ``--seconds``
on it.  A rate keeps up when the median wait before service of the last
quarter of its requests is within two median service times of the first
quarter's.  Prints one JSON line a rate and, last, the table for
``PERF.md`` with the knee and the rate chosen.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import serve as S  # noqa: E402
from benchmark.harness import spec, traffic  # noqa: E402


def one_rate(srv, mix: dict, seed: int, seconds: float) -> dict:
    reqs = traffic.open_schedule(mix, seed, seconds, srv.vocab)
    waits, services, lat = [], [], []
    t0 = time.perf_counter()
    for r in reqs:
        due = t0 + r.at
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        start = time.perf_counter()
        srv.request(r)
        fin = time.perf_counter()
        waits.append(start - due)
        services.append(fin - start)
        lat.append(fin - due)
    q = max(1, len(waits) // 4)
    service = statistics.median(services)
    grows = statistics.median(waits[-q:]) > \
        statistics.median(waits[:q]) + 2 * service
    return {"rate_per_s": mix["rate_per_s"], "requests": len(reqs),
            "p50_ms": 1e3 * S.nearest_rank(lat, 0.5),
            "p95_ms": 1e3 * S.nearest_rank(lat, 0.95),
            "service_ms": 1e3 * service, "keeps_up": not grows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="word-dinov2l.preview")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    srv = S.Server(cell, args.seed, dev)
    mix = cell["traffic_mix"]
    srv.warm(range(mix["words_min"], mix["words_max"] + 1))
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        row = one_rate(srv, dict(mix, rate_per_s=rate), args.seed,
                       args.seconds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    kept = [r["rate_per_s"] for r in rows if r["keeps_up"]]
    knee = max(kept) if kept else None
    print(f"\n{torch.cuda.get_device_name(dev)}; "
          f"{args.seconds:g} s a rate, seed {args.seed}\n")
    print("| rate /s | requests | p50 ms | p95 ms | service ms | keeps up |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['rate_per_s']:g} | {r['requests']} | {r['p50_ms']:.3f} "
              f"| {r['p95_ms']:.3f} | {r['service_ms']:.3f} | "
              f"{'yes' if r['keeps_up'] else 'no'} |")
    if knee is not None:
        print(f"\nknee {knee:g} /s; the cell's rate 0.8 x knee = "
              f"{0.8 * knee:g} /s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
