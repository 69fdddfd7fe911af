"""The program's spans (``utils/profiling.span``): the tree a served
request (with the seq2seq R, or TrOCR's ``R.preprocess``, ``R.encode``,
``R.decode`` and ``R.vocab``) and a train step open under
``torch.profiler``, nothing without one or in train mode, and the same
outputs either way.

Small fp32 configurations on the CPU; the spans are read back from the
profiler's Chrome trace, as the benchmark reads them on the card.
"""

import json

import numpy as np
import pytest
import torch

from affganwriting_torch.gen.inference import (
    encode_labels,
    make_generate_and_read_fn,
)
from affganwriting_torch.train.state import PLAYERS, init_state
from affganwriting_torch.train.step import make_phased_train_step
from affganwriting_torch.utils import profiling
from affganwriting_torch.utils.profiling import span
from test_torch_support import TRAIN_SMALL, small_torch_config, word_batch

torch.set_num_threads(2)   # tier-1 runs six xdist workers

WORDS = ["deep", "tpu", "Hopper", "kernel"]
PHASES = ("rec", "cla", "dis", "gen")
REQUEST_TREE = {
    "serve.request": None, "G": "serve.request", "R": "serve.request",
    "G.upload": "G", "G.encode_style": "G", "G.text_mix": "G", "G.dec": "G",
    "G.dec.res": "G.dec", "G.dec.up": "G.dec", "G.dec.head": "G.dec",
    "R.trunk": "R", "R.bigru": "R", "R.decode": "R"}


def is_program_span(name: str) -> bool:
    """The program's own names, not torch's (``Optimizer.step#...``)."""
    return name in ("G", "R") or name.startswith(
        ("G.", "R.", "serve.", "train.", "step."))


def profiled(fn, tmp_path):
    """``fn()``'s result and the program's spans it opened, (name, start,
    end) in start order, from the profiler's Chrome trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and is_program_span(e["name"]))
    return out, [(n, s, e) for s, e, n in spans]


def parents(spans) -> dict:
    """Each span's innermost enclosing span (None at the top)."""
    out = {}
    for i, (n, s, e) in enumerate(spans):
        around = [(e2 - s2, n2) for j, (n2, s2, e2) in enumerate(spans)
                  if j != i and s2 <= s and e <= e2]
        out.setdefault(n, set()).add(min(around)[1] if around else None)
    return out


def test_span_without_profiler_is_the_shared_no_op(tmp_path):
    assert span("G") is span("train.step") is profiling._NO_SPAN
    with span("outside"):            # opened before the profiler: no range
        _, spans = profiled(lambda: None, tmp_path)
    assert spans == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert span("G") is not profiling._NO_SPAN
        assert span("G", False) is profiling._NO_SPAN


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = small_torch_config()
    run = make_generate_and_read_fn(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    style = rng.normal(size=(1, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
    labels = encode_labels(WORDS, cfg.output_max_len)
    plain = run(style, labels)
    traced, spans = profiled(lambda: run(style, labels),
                             tmp_path_factory.mktemp("serve"))
    return plain, traced, spans


def test_request_opens_the_span_tree_once(served):
    _, _, spans = served
    names = [n for n, _, _ in spans]
    assert sorted(names) == sorted(REQUEST_TREE), names
    assert parents(spans) == {n: {p} for n, p in REQUEST_TREE.items()}


def test_request_outputs_are_bit_equal_with_spans_on(served):
    (img0, ids0), (img1, ids1), _ = served
    assert torch.equal(img0, img1)
    assert torch.equal(ids0, ids1)


TROCR_R = ("R.preprocess", "R.encode", "R.decode", "R.vocab")


@pytest.fixture(scope="module")
def trocr_served(tmp_path_factory):
    """A request with TrOCR as R (``tiny``): untraced, traced, its spans."""
    cfg = small_torch_config(recognizer="trocr", trocr_preset="tiny")
    run = make_generate_and_read_fn(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(1)
    style = rng.normal(size=(1, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
    labels = encode_labels(WORDS, cfg.output_max_len)
    plain = run(style, labels)
    traced, spans = profiled(lambda: run(style, labels),
                             tmp_path_factory.mktemp("trocr"))
    return run, plain, traced, spans


def test_trocr_request_opens_its_spans_under_r(trocr_served):
    *_, spans = trocr_served
    tree = {n: p for n, p in REQUEST_TREE.items()
            if n not in ("R.trunk", "R.bigru", "R.decode")}
    tree.update(dict.fromkeys(TROCR_R, "R"))
    assert sorted(n for n, _, _ in spans) == sorted(tree)
    assert parents(spans) == {n: {p} for n, p in tree.items()}
    order = [n for n, _, _ in spans if n in TROCR_R]
    assert order == list(TROCR_R)


def test_trocr_request_outputs_are_bit_equal_with_spans_on(trocr_served):
    _, (img0, ids0), (img1, ids1), _ = trocr_served
    assert torch.equal(img0, img1)
    assert torch.equal(ids0, ids1)


def test_trocr_in_train_mode_opens_no_span(trocr_served, tmp_path):
    run, (img, _), _, _ = trocr_served
    rec = run.rec.train()
    labels = torch.as_tensor(encode_labels(WORDS, rec.output_max_len))
    try:
        (logits, _), spans = profiled(
            lambda: rec(img.permute(0, 3, 1, 2), labels), tmp_path)
    finally:
        rec.eval()
    assert spans == []
    assert logits.shape[:2] == (len(WORDS), rec.output_max_len - 1)


@pytest.fixture(scope="module", params=[True, False], ids=["merged", "4phase"])
def stepped(request, tmp_path_factory):
    cfg = small_torch_config(**TRAIN_SMALL)
    batch = word_batch(cfg, 4, 7)
    step = make_phased_train_step(cfg, request.param, device="cpu")
    out = []
    for trace in (False, True):
        state = init_state(cfg, device="cpu", seed=1, rec_dropout=0.0)

        def once():
            return step(state, batch, torch.Generator().manual_seed(0))[1]

        metrics, spans = (profiled(once, tmp_path_factory.mktemp("step"))
                          if trace else (once(), None))
        out.append((metrics, {n: getattr(state, n).model.state_dict()
                              for n in PLAYERS}, spans))
    return request.param, out


def test_step_opens_fwd_bwd_opt_under_each_phase(stepped):
    merged, (_, (_, _, spans)) = stepped
    names = [n for n, _, _ in spans]
    want = {"train.step", "step.to_device",
            *(f"step.{p}.{part}" for p in PHASES
              for part in ("fwd", "bwd", "opt"))}
    assert set(names) == want, set(names) ^ want
    assert names.count("train.step") == 1
    # G's pair forward, and in the 4-phase step D's no-grad fakes, are
    # forwards of their own
    assert names.count("step.gen.fwd") == 2
    assert names.count("step.dis.fwd") == (1 if merged else 2)
    assert len(names) <= 24
    assert parents(spans) == {n: {None if n == "train.step" else
                                  "train.step"} for n in want}
    order = [n for n in names if n.endswith((".bwd", ".opt"))]
    assert order == [f"step.{p}.{part}" for p in PHASES
                     for part in ("bwd", "opt")]


def test_step_losses_and_state_are_bit_equal_with_spans_on(stepped):
    _, ((m0, s0, _), (m1, s1, _)) = stepped
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in PLAYERS:
        for k in s0[n]:
            assert torch.equal(s0[n][k], s1[n][k]), f"{n}.{k}"
