"""TrOCR as R in the benchmark: the reference part's tap, a tiny
``word-trocr-base.synth-bulk`` judged by ``serve()`` (and, on the card, the
fp8 control failing the cell's logit limits at its own size), and the
readers of the cell's R (``trocr_*.synth``, ``rec_launches.synth``,
``rec_idle_ms.synth``) on a hand-built Chrome trace and on one the profiler
writes on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import control
from benchmark.harness import data
from benchmark.harness import program_spans as ps
from benchmark.harness import flops, spec, weights, work
from benchmark.harness.checks import checks_of, is_correct
from benchmark.harness.serve import make_program, serve
from benchmark.harness.trace import Trace
from benchmark.harness.traffic import Request
from benchmark.reference import models as ref
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "word-trocr-base.synth-bulk"
READERS = ("trocr_encode_ms.synth", "trocr_decode_ms.synth",
           "rec_launches.synth", "rec_idle_ms.synth", "trocr_fp32_mfu.synth")
MFU = "trocr_fp32_mfu.synth"
DEV = torch.device("cpu")


def tiny_trocr(**mix):
    c = tiny.tiny_cell(CELL, writers=3, words_min=4, words_max=4, **mix)
    c["config_file"]["config"]["trocr_preset"] = "tiny"
    return c


class Ops(TorchDispatchMode):
    """The ops dispatched inside it that are not views."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("side", ["program", "reference"])
@torch.no_grad()
def test_tap_reads_the_forward_and_launches_nothing_until_read(side):
    cfg = tiny_trocr()["config_file"]["config"]
    state = weights.draw(cfg, "rec", 5, DEV)
    if side == "program":
        rec = make_program(cfg, weights.draw(cfg, "gen", 5, DEV), state,
                           DEV).rec
    else:
        rec = weights.materialize(cfg, "rec", state, DEV).eval()
    img = torch.rand(3, 1, 64, 216) * 2 - 1
    labels = torch.as_tensor(data.encode_labels(["tap", "a", "Reads"], 12))
    with Ops() as bare:
        rec(img, labels)
    tap = ref.tap(cfg, rec)
    with Ops() as tapped:
        out = rec(img, labels)
    with Ops() as taken:
        calls = tap.take()
    tap.remove()
    assert tapped.ops == bare.ops and taken.ops == []
    logits = out[0] if side == "program" else out
    (got, fed), = calls()
    assert got.shape == (3, 11, 55) and torch.equal(got, logits)
    assert torch.equal(fed, labels[:, :-1])
    rec(img, labels)                    # removed: reads nothing more
    assert tap.take()() == []


@pytest.fixture
def one_thread():
    """One CPU thread for the test: a request well inside the window on a
    busy host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_cell_is_judged_correct_and_the_fp8_control_is_not(one_thread):
    c = tiny_trocr()
    limits = c["check"]["limits"]
    got = serve(c, 2 ** 31 + 17, 10.0, None, DEV, 0.0)
    assert got["attempted"] > 0 and got["failed"] == 0
    assert is_correct(checks_of(got["numbers"], limits)), got["numbers"]
    fp8 = serve(c, 2 ** 31 + 17, 10.0, None, DEV, 0.0,
                build=control.make_fp8_program)["numbers"]
    assert fp8["logit_rel"] > limits["logit_rel"]
    assert fp8["logit_err"] > limits["logit_err"]


@pytest.mark.card
def test_fp8_control_fails_the_logit_limits_on_the_card(card):
    """The fp8 control at the cell's own size, on three seeds."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "control.py"),
         "--workload", CELL, "--seeds", "101,102,103", "--seconds", "3",
         "--control", "fp8"], capture_output=True, text=True,
        check=True).stdout
    limits = spec.cell(CELL)["check"]["limits"]
    lines = out.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        got = json.loads(line)["numbers"]
        assert got["logit_rel"] > limits["logit_rel"], line
        assert got["logit_err"] > limits["logit_err"], line


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def kernel(corr, s, e, at, cat="cuda_runtime", tid=1):
    """A kernel on the device over [s, e), launched on the host at ``at``."""
    return [ev("kernel", f"k{corr}", s, e - s, tid=7, correlation=corr),
            ev(cat, "cudaLaunchKernel", at, 0.5, tid=tid, correlation=corr)]


def spans(children: bool) -> list:
    """Two requests, [0, 100) and [200, 320), each G then R; TrOCR's four
    children under R where ``children`` holds (the parent's R has none)."""
    out = []
    for t0, r0, kids in ((0, 40, ((41, 45), (45, 75), (75, 95), (95, 99))),
                         (200, 240, ((241, 245), (245, 290), (290, 315),
                                     (315, 318)))):
        end = t0 + (100 if t0 == 0 else 120)
        out += [ev("user_annotation", "serve.request", t0, end - t0),
                ev("user_annotation", "G", t0, r0 - t0),
                ev("user_annotation", "R", r0, end - r0)]
        if children:
            out += [ev("user_annotation", n, s, e - s) for n, (s, e) in
                    zip(("R.preprocess", "R.encode", "R.decode", "R.vocab"),
                        kids)]
    return out


# G's kernel; A's encode (two), decode, vocab; B's encode through the
# driver, decode from the autograd thread; one after both requests; one
# whose launch is not in the trace (in ``hand_built``)
RT, DRV = "cuda_runtime", "cuda_driver"
KERNELS = ((1, 5, 30, 2, RT, 1), (2, 46, 60, 46, RT, 1),
           (3, 60, 80, 50, RT, 1), (4, 80, 90, 76, RT, 1),
           (5, 96, 97, 96, RT, 1),
           (6, 250, 300, 246, DRV, 1), (7, 300, 330, 292, RT, 2),
           (8, 400, 410, 330, RT, 1))


def context(tmp_path, monkeypatch, events) -> dict:
    """A traced run's context over ``events``, its Chrome trace where the
    run writes it: two requests of 4 words of the tiny cell, on an SXM
    card."""
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": events}))
    units = [Request(i, 0.0, 0, ["ab", "c", "de", "f"]) for i in range(2)]
    return {"kind": "closed", "trace": Trace(events, 1.0, 2), "units": units,
            "cell": {"name": CELL},
            "cfg": tiny_trocr()["config_file"]["config"],
            "peaks": work.CARD_PEAKS["SXM"]}


@pytest.fixture
def hand_built():
    events = [e for k in KERNELS for e in kernel(*k)]
    return events + [ev("kernel", "k9", 410, 5, tid=7, correlation=9)]


def test_readers_on_a_hand_built_trace(hand_built, tmp_path, monkeypatch):
    ctx = context(tmp_path, monkeypatch, spans(True) + hand_built)
    got = {n: spec.metric(n).read(ctx) for n in READERS}
    # encode: A 14 + 20 us, B 50 us; decode: A 10 us, B 30 us; R's
    # launches: A 4, B 2; idle: A's gaps from 90 (in R.decode) and from
    # 97 (in R.vocab), B none (its last gap begins outside); R's kernels:
    # A 45 us, B 80 us
    r = spec.metric(MFU).rec_flops(ctx["cfg"], 4)
    assert got == pytest.approx({
        "trocr_encode_ms.synth": 0.042, "trocr_decode_ms.synth": 0.020,
        "rec_launches.synth": 3.0, "rec_idle_ms.synth": 0.0795,
        MFU: 100.0 * 2 * r / (125e-6 * 67e12)})
    assert all(spec.metric(n).read(dict(ctx, kind="train")) is None
               for n in READERS)
    seq2seq = dict(ctx["cfg"], recognizer="seq2seq")
    assert spec.metric(MFU).read(dict(ctx, cfg=seq2seq)) is None


def test_a_program_without_trocrs_spans(hand_built, tmp_path, monkeypatch):
    """The parent's R opens no child: no device time by child, and R's
    launches, idle and float32 share still read."""
    ctx = context(tmp_path, monkeypatch, spans(False) + hand_built)
    got = {n: spec.metric(n).read(ctx) for n in READERS}
    full = context(tmp_path, monkeypatch, spans(True) + hand_built)
    assert got["trocr_encode_ms.synth"] is None
    assert got["trocr_decode_ms.synth"] is None
    assert got["rec_launches.synth"] == 3.0
    assert got["rec_idle_ms.synth"] == pytest.approx(0.0795)
    assert got[MFU] == pytest.approx(spec.metric(MFU).read(full))
    absent = dict(context(tmp_path, monkeypatch, spans(False) + hand_built),
                  cell={"name": "absent"})
    assert all(spec.metric(n).read(absent) is None for n in READERS)


@torch.no_grad()
def test_readers_on_a_cpu_trace(tmp_path, monkeypatch):
    c = tiny_trocr()
    cfg = c["config_file"]["config"]
    run = make_program(cfg, weights.draw(cfg, "gen", 3, DEV),
                       weights.draw(cfg, "rec", 3, DEV), DEV)
    pool = data.StylePool(3, cfg, 1, DEV)
    labels = data.encode_labels(["cpu", "trace"], 12)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(pool.stacks[:1], labels)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ctx = context(tmp_path, monkeypatch, events)
    got = {n: spec.metric(n).read(ctx) for n in READERS}
    # a CPU trace has no device kernels, so no device time to divide by
    assert got.pop(MFU) is None
    assert all(isinstance(v, (int, float)) for v in got.values()), got


def test_r_flops_are_the_harness_counts_r_part():
    """The float32 share's FLOPs are R's part of ``flops.serve``: two
    configurations with one G differ there by their Rs' counts alone."""
    count = spec.metric(MFU).rec_flops
    base, seq2seq = (spec.config(n)["config"] for n in
                     ("affgan-word-trocr-base", "affgan-word-resnet50"))
    assert (flops.serve(base, 2) - flops.serve(seq2seq, 2)
            == count(base, 2) - count(seq2seq, 2))
    # the TrOCR-base R a word: the ViT, the cross attention's k and v and
    # the decoder at 11 positions, as PERF.md counts them
    assert 130e9 < count(base, 1) < 145e9
