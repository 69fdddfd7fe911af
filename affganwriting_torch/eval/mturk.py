"""Human-study (MTurk) preference analysis.

The port's copy of ``affganwriting_tpu/eval/mturk.py`` (the reference's
line_generation/parse_mturk.py): given pairwise choices between real and
generated samples (CSV with columns ``worker,item,choice``, choice
'real' or 'generated', or any two labels), the per-item and overall
preference rates with a bootstrap 95% interval.
"""

from __future__ import annotations

import csv
from collections import defaultdict

import numpy as np


def parse_choices(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def preference_stats(rows: list[dict], positive: str = "generated",
                     n_boot: int = 1000, seed: int = 0) -> dict:
    if not rows:
        return {"rate": 0.0, "n": 0, "ci95": (0.0, 0.0), "per_item": {}}
    flags = np.asarray(
        [1.0 if r["choice"] == positive else 0.0 for r in rows])
    rng = np.random.default_rng(seed)
    boots = [
        float(np.mean(flags[rng.integers(len(flags), size=len(flags))]))
        for _ in range(n_boot)
    ]
    lo, hi = np.percentile(boots, [2.5, 97.5])
    per_item: dict[str, list[float]] = defaultdict(list)
    for r, f in zip(rows, flags):
        per_item[r.get("item", "?")].append(float(f))
    return {
        "rate": float(flags.mean()),
        "n": int(len(flags)),
        "ci95": (float(lo), float(hi)),
        "per_item": {k: float(np.mean(v)) for k, v in per_item.items()},
    }


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csv_path")
    p.add_argument("--positive", default="generated")
    args = p.parse_args(argv)
    stats = preference_stats(parse_choices(args.csv_path), args.positive)
    print(json.dumps({k: v for k, v in stats.items() if k != "per_item"}))


if __name__ == "__main__":
    main()
