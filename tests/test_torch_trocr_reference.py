"""The port's TrOCR recognizer against the benchmark's float32 reference
(``benchmark/reference/rec_trocr.py``), on the CPU at small widths.

Weights come from the benchmark's own draw (``benchmark.harness.weights``),
with every rank-1 tensor (biases, LayerNorm scales) moved off its 0 or 1 by
seeded noise so that those paths are compared too.

- ``TrOCRRecognizer`` against the reference part: logits within ``TOL`` of
  the reference's largest magnitude, at ``tiny`` (one width throughout),
  at a decoder wider than the encoder whose cross attention reads the
  encoder's width (``cross_attention_hidden_size``, as trocr-base sets),
  and at widths that differ without it (the ``enc_to_dec_proj`` linear).
  Measured: 3.7e-8 to 4.4e-8 (the largest magnitude is the mask's 30);
- the same R under bfloat16 autocast misses ``TOL`` by more than an order
  (measured 5.8e-4 to 9.7e-4), so the comparison catches a lower
  precision;
- ``make_generate_and_read_fn`` with ``recognizer: "trocr"`` in float32
  against the reference's G and R: images within 2e-4, R's logits (read by
  the part's tap) within ``TOL``, its ids the logits' argmax, the ids it
  fed itself ``labels[:, :-1]``.
"""

import dataclasses

import pytest
import torch

from affganwriting_torch.core.config import WordGanConfig
from affganwriting_torch.gen.inference import make_generate_and_read_fn
from affganwriting_torch.models.recognizer.trocr import (
    TrOCRArch,
    TrOCRRecognizer,
)
from benchmark.harness import data, weights
from benchmark.reference import models as ref
from benchmark.reference import rec_trocr
from benchmark.tests import tiny

torch.set_num_threads(2)   # tier-1 runs six xdist workers

DEV = torch.device("cpu")
TOL = 1e-5          # max |program - reference| over max |reference|
WORDS = ["hello", "a", "Worldwide", "TrOCR"]

TINY = rec_trocr.PRESETS["tiny"]
ARCHS = {
    "tiny": (TrOCRArch.tiny(), TINY),
    "cross": (TrOCRArch(enc_hidden=32, enc_layers=2, enc_heads=2,
                        enc_mlp=64, dec_hidden=48, dec_layers=2, dec_heads=3,
                        dec_ffn=96, vocab_tro=384, max_positions=64,
                        cross_attention_hidden_size=32),
              dict(TINY, dec_hidden=48, dec_heads=3, dec_ffn=96,
                   cross_kv=32)),
    "proj": (TrOCRArch(enc_hidden=32, enc_layers=2, enc_heads=2, enc_mlp=64,
                       dec_hidden=48, dec_layers=2, dec_heads=3, dec_ffn=96,
                       vocab_tro=384, max_positions=64),
             dict(TINY, dec_hidden=48, dec_heads=3, dec_ffn=96)),
}


def config(preset: str) -> dict:
    cell = tiny.tiny_cell("word-trocr-base.synth-bulk")
    return dict(cell["config_file"]["config"], trocr_preset=preset,
                compute_dtype="float32")


def draw(cfg: dict, seed: int) -> dict:
    """The benchmark's weights for R, rank-1 tensors moved by noise."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=gen)
            if v.dim() == 1 else v
            for k, v in weights.draw(cfg, "rec", seed, DEV).items()}


def inputs(seed: int):
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(len(WORDS), 1, 64, 216, generator=gen) * 2 - 1
    return img, torch.as_tensor(data.encode_labels(WORDS, 12))


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b).abs().max() / b.abs().max())


@pytest.fixture(params=sorted(ARCHS))
def pair(request, monkeypatch):
    """(program R, reference R) of one set of widths, same weights."""
    arch, widths = ARCHS[request.param]
    monkeypatch.setitem(rec_trocr.PRESETS, request.param, widths)
    cfg = config(request.param)
    state = draw(cfg, 11)
    prog = TrOCRRecognizer(arch, 12)
    prog.load_state_dict(state, strict=True)
    assert hasattr(prog.core, "enc_to_dec_proj") == (request.param == "proj")
    return prog.eval(), weights.materialize(cfg, "rec", state, DEV).eval()


@torch.no_grad()
def test_program_r_agrees_with_the_reference(pair):
    prog, r = pair
    img, labels = inputs(3)
    logits, _ = prog(img, labels)
    want = r(img, labels)
    assert logits.shape == want.shape == (len(WORDS), 11, 55)
    assert gap(logits, want) < TOL


@torch.no_grad()
def test_bf16_r_misses_the_tolerance(pair):
    prog, r = pair
    img, labels = inputs(4)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        logits, _ = prog(img, labels)
    assert gap(logits, r(img, labels)) > 10 * TOL


def test_generate_and_read_agrees_with_the_reference():
    cfg = config("tiny")
    fields = {f.name for f in dataclasses.fields(WordGanConfig)}
    pc = WordGanConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in fields})
    w = {"gen": weights.draw(cfg, "gen", 7, DEV), "rec": draw(cfg, 7)}
    run = make_generate_and_read_fn(pc, w["gen"], w["rec"], device=DEV)
    assert isinstance(run.rec, TrOCRRecognizer)
    pool = data.StylePool(3, cfg, 2, DEV)
    labels = data.encode_labels(data.corpus()[:3], 12)
    tap = ref.tap(cfg, run.rec)
    imgs, ids = run(pool.stacks[:1], labels)
    (logits, fed), = tap.take()()
    tap.remove()
    g = weights.materialize(cfg, "gen", w["gen"], DEV).eval()
    r = weights.materialize(cfg, "rec", w["rec"], DEV).eval()
    with torch.no_grad():
        lab = torch.as_tensor(labels)
        x = g.generate(g.encode_style(torch.as_tensor(pool.stacks[:1])), lab)
        rl = r(imgs.permute(0, 3, 1, 2).float(), lab, feed=ids)
    torch.testing.assert_close(x.permute(0, 2, 3, 1), imgs, atol=2e-4,
                               rtol=0)
    assert gap(logits, rl) < TOL
    assert torch.equal(ids, logits.argmax(-1))
    assert torch.equal(fed, lab[:, :-1])
