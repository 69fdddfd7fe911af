"""The readers of the program's spans (``harness/program_spans.py`` and
the twelve metrics over it) on a hand-built Chrome trace: containment,
innermost-span idle attribution, launches from two host threads, and the
normalisation by request and by step; the readers take the trace from the
file a traced run writes."""

import json

import pytest

from benchmark.harness import program_spans as ps
from benchmark.harness import spec
from benchmark.harness.trace import Trace

SYNTH = ("gen_launches.synth", "rec_launches.synth", "gen_host_ms.synth",
         "rec_host_ms.synth", "gen_idle_ms.synth", "rec_idle_ms.synth")
TRAIN = ("fwd_host_ms.train", "bwd_host_ms.train", "opt_host_ms.train",
         "fwd_launches.train", "bwd_launches.train", "opt_launches.train")


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def span(name, s, e):
    return ev("user_annotation", name, s, e - s)


REQUEST = ("serve.request", "G", "G.upload", "G.encode_style", "G.text_mix",
           "G.dec", "G.dec.res", "G.dec.up", "G.dec.head", "R", "R.trunk",
           "R.bigru", "R.decode")
# request A: G 60, R 35; request B: G 80, R 35 (microseconds)
BOUNDS_A = ((0, 100), (0, 60), (0, 5), (5, 20), (20, 25), (25, 60),
            (25, 35), (35, 50), (50, 60), (60, 95), (60, 70), (70, 75),
            (75, 95))
BOUNDS_B = ((200, 320), (200, 280), (200, 205), (205, 220), (220, 225),
            (225, 280), (225, 235), (235, 260), (260, 280), (280, 315),
            (280, 287), (287, 289), (289, 315))


def kernel(corr, s, e, at, cat="cuda_runtime", tid=1):
    """A kernel on the device over [s, e), launched on the host at ``at``."""
    return [ev("kernel", f"k{corr}", s, e - s, tid=7, correlation=corr),
            ev(cat, "cudaLaunchKernel", at, 0.5, tid=tid, correlation=corr)]


def program(events, units):
    """The readers' view of a trace of ``events``; ``events`` kept for
    ``traced``."""
    prog = ps.Program(Trace(events, 1.0, units), events)
    prog.events = events
    return prog


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """The context of a traced run of ``prog``'s events: its Chrome trace
    written where the run writes it, and the ``Trace`` made from it."""
    monkeypatch.setattr(ps, "TRACES", tmp_path)

    def make(prog, kind):
        (tmp_path / "cell.json").write_text(
            json.dumps({"traceEvents": prog.events}))
        return {"kind": kind, "trace": Trace(prog.events, 1.0, 1),
                "units": prog.trace.units, "cell": {"name": "cell"}}
    return make


@pytest.fixture
def served():
    """Request A over [0, 100) (G 60, R 35), request B over [200, 320) (G
    80, R 35).  Device busy [2,8) [10,30) [40,45) [62,80) [96,98)
    [120,125) [210,215) [300,310); the benchmark's own hook ranges and a
    copy's runtime call lie in the trace too."""
    events = [span(n, *b) for bounds in (BOUNDS_A, BOUNDS_B)
              for n, b in zip(REQUEST, bounds)] + [
        span("gen", 6, 59), span("style", 6, 19), span("rec", 61, 94),
        ev("gpu_memcpy", "Memcpy HtoD", 3, 1, tid=7, correlation=90),
        ev("cuda_runtime", "cudaMemcpyAsync", 2, 1, correlation=90),
        ev("cuda_driver", "cuLaunchKernel", 6.5, 0.5, correlation=2)]
    for args in ((1, 2, 8, 1), (2, 10, 30, 6), (4, 62, 80, 61),
                 (5, 96, 98, 97), (6, 120, 125, 110), (7, 210, 215, 201),
                 (8, 300, 310, 290)):
        events += kernel(*args)
    events += kernel(3, 40, 45, 36, cat="cuda_driver")   # a ctypes launch
    return program(events, 2)


def test_spans_are_the_programs_and_hold_their_children(served):
    tree = ps.Tree(served)
    assert tree.tops == [(0, 100), (200, 320)]
    assert all(ps.is_program(n) for sp in tree.inside for _, _, n in sp)
    assert ps.host_ms(served, ps.in_gen) == [0.060, 0.080]
    assert ps.host_ms(served, ps.in_rec) == [0.035, 0.035]
    assert ps.host_ms(served, lambda n: n == "G.dec.up") == [0.015, 0.025]


def test_each_kernel_launch_counts_once_where_it_was_made(served):
    assert len(served.launches) == 8         # not the copy's call
    assert ps.launches(served, ps.in_gen) == [3, 1]
    assert ps.launches(served, ps.in_rec) == [1, 1]
    inside = ps.launches(served, lambda n: n in ps.TOPS)
    assert inside == [5, 2]                  # the kernel at 110: outside


def test_idle_goes_to_the_innermost_program_span(served):
    assert ps.idle_by_span(served) == pytest.approx({
        "G.encode_style": 87e-6, "G.dec.res": 10e-6, "G.dec.up": 17e-6,
        "R.decode": 16e-6, "serve.request": 22e-6, ps.OUTSIDE: 85e-6})
    assert ps.idle_ms(served, ps.in_gen) == pytest.approx([0.029, 0.085])
    assert ps.idle_ms(served, ps.in_rec) == pytest.approx([0.016, 0.0])


def test_synth_readers_normalise_by_request(served, traced):
    ctx = traced(served, "closed")
    got = {n: spec.metric(n).read(ctx) for n in SYNTH}
    assert got == pytest.approx({
        "gen_launches.synth": 2.0, "rec_launches.synth": 1.0,
        "gen_host_ms.synth": 0.070, "rec_host_ms.synth": 0.035,
        "gen_idle_ms.synth": 0.057, "rec_idle_ms.synth": 0.008})
    assert all(spec.metric(n).read(dict(ctx, kind="train")) is None
               for n in SYNTH)


STEP = (("step.to_device", 10), ("step.rec.fwd", 20), ("step.rec.bwd", 30),
        ("step.rec.opt", 5), ("step.cla.fwd", 10), ("step.cla.bwd", 10),
        ("step.cla.opt", 5), ("step.gen.fwd", 40), ("step.dis.fwd", 10),
        ("step.dis.bwd", 10), ("step.dis.opt", 5), ("step.gen.fwd", 20),
        ("step.gen.bwd", 50), ("step.gen.opt", 5))


def step(t0, scale, corr):
    """A step's spans from ``t0``, each ``scale`` x its ``STEP`` length,
    and a kernel launched in each: two from the autograd engine's thread
    in each backward; the batch's own launch before the step."""
    events, t = [span("train.step", t0, t0 + 240 * scale)], t0
    events += kernel(corr, t0 - 4, t0 - 3, t0 - 5)
    for name, d in STEP:
        events.append(span(name, t, t + d * scale))
        tids = (2, 2) if name.endswith(".bwd") else (1,)
        for i, tid in enumerate(tids):
            corr += 1
            events += kernel(corr, t + 2, t + 3, t + 1 + i, tid=tid)
        t += d * scale
    return events, corr


@pytest.fixture
def stepped():
    a, corr = step(1000, 1, 0)
    b, _ = step(2000, 2, corr + 1)
    return program(a + b + [span("Optimizer.step#Adam.step", 1075, 1080)],
                   2)


def test_train_readers_normalise_by_step(stepped, traced):
    ctx = traced(stepped, "train")
    got = {n: spec.metric(n).read(ctx) for n in TRAIN}
    assert got == pytest.approx({
        "fwd_host_ms.train": 0.150, "bwd_host_ms.train": 0.150,
        "opt_host_ms.train": 0.030, "fwd_launches.train": 5.0,
        "bwd_launches.train": 8.0, "opt_launches.train": 4.0})
    # the phases and the copy in hold every launch of the step
    parts = [ps.launches(stepped, ps.step_part(p))
             for p in ("fwd", "bwd", "opt")]
    to_dev = ps.launches(stepped, lambda n: n == "step.to_device")
    assert [sum(c) for c in zip(*parts, to_dev)] == ps.launches(
        stepped, lambda n: n == "train.step") == [18, 18]
    assert len(stepped.launches) == 38       # the two batches' too
    assert all(spec.metric(n).read(dict(ctx, kind="closed")) is None
               for n in TRAIN)


@pytest.mark.parametrize("name", SYNTH + TRAIN)
def test_no_program_spans_no_number(name, traced):
    """A program that opens no span (the parent's) reads as no number, and
    so does a run whose trace file is not there."""
    events = kernel(1, 2, 8, 1) + [span("gen", 0, 10), span("rec", 10, 20)]
    kind = "train" if name.endswith(".train") else "closed"
    ctx = traced(program(events, 1), kind)
    assert spec.metric(name).read(ctx) is None
    assert spec.metric(name).read(dict(ctx, cell={"name": "absent"})) is None
