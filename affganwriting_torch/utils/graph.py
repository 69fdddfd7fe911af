"""Loss-curve plotting from metrics.jsonl (line_generation/graph.py).

The port's copy of ``affganwriting_tpu/utils/graph.py`` (plain Python,
the same series): ``python -m affganwriting_torch.utils.graph
runs/word_gan/metrics.jsonl`` writes a matplotlib PNG when matplotlib is
installed, an ASCII sparkline summary otherwise.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict


def load_series(path: str) -> dict[str, list[tuple[int, float]]]:
    series: dict[str, list[tuple[int, float]]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            step = rec.get("step", 0)
            group = rec.get("group", "train")
            for k, v in rec.items():
                if k in ("step", "time", "group"):
                    continue
                if isinstance(v, (int, float)):
                    series[f"{group}/{k}"].append((step, float(v)))
    return dict(series)


_BARS = " .:-=+*#%@"


def sparkline(values: list[float], width: int = 40) -> str:
    if not values:
        return ""
    stride = max(1, len(values) // width)
    vals = values[::stride][:width]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _BARS[int((v - lo) / span * (len(_BARS) - 1))] for v in vals)


def plot(path: str, out: str = "losses.png") -> str:
    """Plot every series of ``path`` into ``out`` and return ``out``; without
    matplotlib print one sparkline a series and return ""."""
    series = load_series(path)
    try:
        import matplotlib
    except ImportError:
        for name, pts in sorted(series.items()):
            vals = [v for _, v in pts]
            print(f"{name:32s} [{sparkline(vals)}] "
                  f"last={vals[-1]:.4f} min={min(vals):.4f}")
        return ""
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    for name, pts in sorted(series.items()):
        steps, vals = zip(*pts)
        ax.plot(steps, vals, label=name, alpha=0.8)
    ax.legend(fontsize=7)
    ax.set_xlabel("step")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


if __name__ == "__main__":
    plot(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "losses.png")
