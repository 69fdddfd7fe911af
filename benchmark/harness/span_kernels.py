"""Device time of the kernels launched inside the program's spans.

Each device kernel of a traced stretch is matched by its correlation id to
the runtime or driver call that launched it, on whichever host thread, and
its device time goes to the program spans open at that call's host time
(``program_spans.Tree``): the work a layer of the program asked for, where
the stream ran it.  The spans and the launches are read from the Chrome
trace the run wrote (``program_spans.of``'s file), the kernels' times once
a run and kept on the ``Trace``.  A trace in which no span is accepted
(a program that opens none of them) reads as no number.
"""

from __future__ import annotations

import json

from benchmark.harness import program_spans as ps


def launched_kernels(events: list) -> list[tuple[float, float]]:
    """(host time of its launch, device microseconds) of each kernel whose
    launching call is in the trace.  It mirrors
    ``program_spans.launch_times`` (the same launch categories, the same
    correlation map) and keeps each kernel's duration besides, so the two
    must change together; ``Program`` could keep these pairs and derive its
    launch times from them."""
    calls = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ps.LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                calls.setdefault(c, e["ts"])
    return [(calls[c], e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and (c := e.get("args", {}).get("correlation")) in calls]


def _kernels(ctx: dict) -> list[tuple[float, float]]:
    tr = ctx["trace"]
    kernels = getattr(tr, "span_kernels", None)
    if kernels is None:
        name = ctx.get("cell", {}).get("name", "")
        path = next(p for p in (ps.TRACES / f"{name}.json",
                                ps.TRACES / f"{name}.rank0.json")
                    if p.is_file())
        events = json.loads(path.read_text())["traceEvents"]
        kernels = tr.span_kernels = launched_kernels(events)
    return kernels


def device_ms(ctx: dict, match) -> list[float] | None:
    """A top span's device milliseconds of the kernels launched inside the
    spans ``match`` accepts, one value a top span (a request), in order;
    None without a trace or without such a span."""
    prog = ps.of(ctx)
    if prog is None or not any(match(n) for _, _, n in prog.annotations):
        return None
    tree = ps.Tree(prog)
    out = [0.0] * len(tree.tops)
    for at, dur in _kernels(ctx):
        k, open_ = tree.holding(at)
        if k is not None and any(match(n) for _, _, n in open_):
            out[k] += dur / 1e3
    return out
