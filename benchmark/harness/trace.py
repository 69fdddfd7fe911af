"""The traced sub-window: ``torch.profiler`` over a bounded steady stretch
of the window, reduced to what the per-layer metrics read.

``Trace`` holds the device activities (kernels, copies, sets) of the
profiled stretch with their times, the host's operators, and the
stretch's length on the host clock (from a synchronize to a synchronize).
The busy time is the union of the device intervals; the idle gaps between
them are labelled by the host operator running when each began.
"""

from __future__ import annotations

import bisect
import collections
import json
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profiled:
    """Profile from ``start()`` to ``stop()``; ``trace()``, after the
    window, writes the Chrome trace to ``path`` (replaced each run) and
    reads it back as a ``Trace``."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.prof = None
        self.stopped = False

    def start(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        torch.cuda.synchronize()
        self.window, self.units = time.perf_counter() - self.t0, units
        self.prof.stop()
        self.stopped = True

    def trace(self) -> "Trace | None":
        if self.prof is None:
            return None
        if not self.stopped:
            raise RuntimeError("trace() before stop()")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        events = json.loads(self.path.read_text())["traceEvents"]
        return Trace(events, self.window, self.units)


class Trace:
    def __init__(self, events: list, window_s: float, units: int):
        self.window_s, self.units = window_s, units
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.kernels = [(e["name"], e["ts"], e["dur"]) for e in dev
                        if e["cat"] == "kernel"]
        self.device = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                             for e in dev)
        self.host = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                           for e in events if e.get("ph") == "X"
                           and e.get("cat") == "cpu_op")

    def busy_intervals(self):
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, match) -> float:
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(d for n, _, d in self.kernels if match(n)) / 1e6

    def kernel_count(self, match=lambda n: True) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def top_ops(self, k: int = 10):
        tot = collections.Counter()
        for n, _, d in self.kernels:
            tot[n[:120]] += d / 1e6
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """The device's idle gaps summed by the innermost host operator
        running when each began, the ``k`` largest."""
        starts = [h[0] for h in self.host]
        tot = collections.Counter()
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            label, i = "host: no operator", bisect.bisect_right(starts, e0)
            best = None
            for j in range(i - 1, max(-1, i - 400), -1):
                hs, he, hn = self.host[j]
                if hs <= e0 < he and (best is None or hs >= best[0]):
                    best = (hs, hn)
            if best is not None:
                label = best[1][:120]
            tot[label] += (s1 - e0) / 1e6
        return [[n, s] for n, s in tot.most_common(k)]
