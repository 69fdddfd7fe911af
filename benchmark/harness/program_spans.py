"""The program's own spans in a traced stretch, read against the host's
kernel launches and the device's idle gaps.

The port opens its spans (``affganwriting_torch/utils/profiling.span``)
only under a running profiler: ``record_function`` ranges, which the
Chrome trace holds as ``user_annotation`` events.  A request is
``serve.request`` over ``G`` (``G.upload``, ``G.encode_style``,
``G.text_mix``, ``G.dec`` over ``G.dec.res``, ``G.dec.up``,
``G.dec.head``) and ``R`` (``R.trunk``, ``R.bigru``, ``R.decode``); a step
is ``train.step`` over ``step.to_device`` and ``step.<phase>.fwd``,
``.bwd``, ``.opt`` and ``.allreduce``.  The benchmark's own hook ranges
(``style``, ``gen``, ``rec``) and torch's (``Optimizer.step#...``) are not
the program's and are left out.  A trace without program spans (a program
that opens none) reads as no number.

``Trace`` keeps neither the spans nor the launches, so ``of(ctx)`` reads
them from the Chrome trace the run wrote (``build/bench_traces/<cell>.json``,
``Profiled``'s path), once a run, beside the ``Trace``'s device intervals.

- Host time: a span's length on the host clock.
- Launches (``Program.launches``): the host time of the runtime or driver
  call that launched each device kernel, matched by correlation id, one a
  kernel, from any host thread (the backward's launches come from the
  autograd engine's thread); a launch is inside every span whose interval
  holds its time.
- Idle: each idle gap of the device (between the union's busy intervals,
  as ``Trace.idle_gaps``) goes to the innermost program span open when it
  began, or to ``OUTSIDE`` where none is.

Each reading is a list with one value a top span (a request or a step),
in order; the readers take its median or mean.
"""

from __future__ import annotations

import bisect
import json
import statistics
from pathlib import Path

TRACES = Path(__file__).resolve().parents[2] / "build" / "bench_traces"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOPS = ("serve.request", "train.step")
OUTSIDE = "outside"


def is_program(name: str) -> bool:
    return name in ("G", "R") or name.startswith(
        ("G.", "R.", "serve.", "train.", "step."))


def in_gen(name: str) -> bool:
    """``G`` and its children."""
    return name == "G" or name.startswith("G.")


def in_rec(name: str) -> bool:
    """``R`` and its children."""
    return name == "R" or name.startswith("R.")


def step_part(part: str):
    """``step.<phase>.<part>`` of every phase (``fwd``, ``bwd``, ``opt``)."""
    return lambda name: name.startswith("step.") and name.endswith(
        "." + part) and name.count(".") == 2


class Program:
    """What the readers take of one traced stretch: the ``Trace`` (its
    device busy intervals) and, from the same run's events, the program's
    spans and the host time of each kernel's launch."""

    def __init__(self, trace, events: list):
        self.trace = trace
        self.annotations = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation")
        self.launches = launch_times(events)

    def busy_intervals(self):
        return self.trace.busy_intervals()


def launch_times(events: list) -> list[float]:
    """The host time of each device kernel's launch, one a kernel: the
    runtime or driver call that carries the kernel's correlation id, from
    whichever host thread made it."""
    calls = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                calls.setdefault(c, e["ts"])
    return sorted(calls[c] for c in (
        e.get("args", {}).get("correlation") for e in events
        if e.get("ph") == "X" and e.get("cat") == "kernel") if c in calls)


def of(ctx: dict) -> "Program | None":
    """The ``Program`` of a traced run's context, or None without a trace
    or its file; read once and kept on the ``Trace``."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    prog = getattr(tr, "program_spans", None)
    if prog is None:
        name = ctx.get("cell", {}).get("name", "")
        path = next((p for p in (TRACES / f"{name}.json",
                                 TRACES / f"{name}.rank0.json")
                     if p.is_file()), None)
        if path is None:
            return None
        events = json.loads(path.read_text())["traceEvents"]
        prog = tr.program_spans = Program(tr, events)
    return prog


class Tree:
    """The program's spans of one trace, grouped by the top span that
    holds them; tops do not overlap."""

    def __init__(self, prog):
        # in start order, an outer span before an inner one that starts
        # with it
        spans = sorted(((s, e, n) for s, e, n in
                        prog.annotations if is_program(n)),
                       key=lambda sp: (sp[0], -sp[1]))
        self.tops = [(s, e) for s, e, n in spans if n in TOPS]
        self.starts = [s for s, _ in self.tops]
        self.inside = [[] for _ in self.tops]
        for s, e, n in spans:
            k = self.top_of(s)
            if k is not None:
                self.inside[k].append((s, e, n))

    def top_of(self, t: float):
        """The index of the top span holding time ``t``, or None."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t < self.tops[k][1]:
            return k
        return None

    def holding(self, t: float):
        """The top's index and the spans open at ``t``, outermost first."""
        k = self.top_of(t)
        if k is None:
            return None, []
        return k, [sp for sp in self.inside[k] if sp[0] <= t < sp[1]]


def host_ms(prog, match) -> list[float]:
    """A top span's host milliseconds inside the spans ``match`` accepts
    (the outermost of them, so nested matches count once)."""
    tree = Tree(prog)
    out = []
    for spans in tree.inside:
        total, end = 0.0, float("-inf")
        for s, e, n in spans:            # in start order
            if match(n) and s >= end:
                total, end = total + (e - s), e
        out.append(total / 1e3)
    return out


def launches(prog, match) -> list[int]:
    """A top span's kernel launches inside the spans ``match`` accepts."""
    tree = Tree(prog)
    out = [0] * len(tree.tops)
    for t in prog.launches:
        k, open_ = tree.holding(t)
        if k is not None and any(match(n) for _, _, n in open_):
            out[k] += 1
    return out


def idle_ms(prog, match) -> list[float]:
    """A top span's device idle milliseconds put down to the spans
    ``match`` accepts: each gap to the innermost span open as it began."""
    tree = Tree(prog)
    out = [0.0] * len(tree.tops)
    for name, k, gap in gaps(prog, tree):
        if k is not None and match(name):
            out[k] += gap / 1e3
    return out


def idle_by_span(prog) -> dict[str, float]:
    """Seconds of device idle by the innermost program span open as each
    gap began, ``OUTSIDE`` where none was."""
    tot: dict[str, float] = {}
    for name, _, gap in gaps(prog, Tree(prog)):
        tot[name] = tot.get(name, 0.0) + gap / 1e6
    return tot


def gaps(prog, tree: Tree):
    """(innermost span's name or ``OUTSIDE``, top index or None, gap in
    microseconds) of each idle gap of the device."""
    busy = prog.busy_intervals()
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        k, open_ = tree.holding(e0)
        name = open_[-1][2] if open_ else OUTSIDE
        yield name, k, s1 - e0


def median(values):
    return statistics.median(values) if values else None


def mean(values):
    return sum(values) / len(values) if values else None
