"""G's decoder replayed as CUDA graphs (``utils/cuda_graphs.py`` applied to
``models/decoder.Decoder``), and the serving entry's one label upload.

On the CPU, with the stand-in graph of ``test_torch_style_graph.py``
(``CpuGraph``, ``as_card``): the replay equals the eager forward; the key
covers every tensor, each tap of the style pyramid and the non-tensor
arguments; train mode, grad, an int8 mode and a dispatch mode run eager
and keep no graph; hooks on the decoder fire once a call; outputs of one
call survive the next; a second ``eval()`` and a change of quant mode
keep the graphs (a float call after an int8 call replays), while
``train()`` then ``eval()`` and ``.to()`` drop them; the cap, read from
the class, holds the preview's 1-8 words and the bulk 128; the eval
step keeps its graphs across calls; ``run`` uploads the labels once and
hands R the tensor G took.

On the card (``card``; skips without one): the decoder's replay is its
eager forward bit for bit at 128 words and at 1-8, and a float call after
an int8 call replays the graph it had;
``make_generate_and_read_fn``'s images and ids are the eager run's bit for
bit; a profiled request holds ``G.dec.replay`` inside ``G.dec`` and the
kernels of ``in_relu`` and ``phase_head``.  This file imports no JAX; on
the card: ``python -m pytest --noconftest tests/test_torch_decoder_graph.py
-m card``.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_style_graph import (  # noqa: F401 (fixtures)
    SERVE_H,
    SERVE_W,
    WORDS,
    CpuGraph,
    as_card,
    card,
    card_stacks,
    lecun_init,
    small_config,
    stacks,
)
from torch import nn

from affganwriting_torch.core.config import default_config
from affganwriting_torch.gen.inference import (
    build_generator,
    encode_labels,
    make_generate_and_read_fn,
)
from affganwriting_torch.models.decoder import Decoder
from affganwriting_torch.utils import cuda_graphs
from affganwriting_torch.utils.profiling import op_counts

torch.set_num_threads(2)   # tier-1 runs six xdist workers

BULK = 128
SIZES = [*range(1, 9), BULK]     # the preview's words a request, the bulk's


@pytest.fixture
def gen():
    return build_generator(small_config(), "cpu", seed=3)


def words(n, seed=0):
    rng = np.random.default_rng(seed)
    return [WORDS[i] for i in rng.integers(0, len(WORDS), n)]


def dec_args(gen, n, seed=0, dev="cpu"):
    """The decoder's arguments for ``n`` words in one writer's style, as
    ``Generator.generate`` passes them: content, AdaIN parameters and the
    style pyramid (batch 1), each from the eager forwards."""
    cfg = small_config() if dev == "cpu" else default_config()
    stack = (torch.as_tensor(stacks(cfg, 1, seed)[0], device=dev)
             if dev == "cpu" else card_stacks(dev, seed + 1)[seed])
    labels = torch.as_tensor(encode_labels(words(n, seed),
                                           cfg.output_max_len),
                             device=dev).long()
    enc = gen.enc_image
    with torch.inference_mode():
        pyramid = type(enc).forward.__wrapped__(enc, stack.permute(0, 3, 1, 2))
        adain, content = gen.text_encoder(labels, pyramid[-1].shape[2:])
        mixed = gen.linear_mix(pyramid[-1], content)
    return mixed, adain, pyramid


def eager(dec, *args):
    return Decoder.forward.__wrapped__(dec, *args)


def test_the_decoder_replays_through_the_shared_path():
    assert Decoder.forward.__wrapped__.__name__ == "forward"
    assert Decoder.train.__module__ == cuda_graphs.__name__
    assert Decoder._apply.__module__ == cuda_graphs.__name__
    assert Decoder.MAX_GRAPHS == 12


def test_replay_is_the_eager_forward(gen, as_card):
    dec = gen.dec
    a, b = dec_args(gen, 4, seed=0), dec_args(gen, 4, seed=1)
    with torch.inference_mode():
        want_a, want_b = eager(dec, *a), eager(dec, *b)
        got = [dec(*a), dec(*b), dec(*a)]
    assert CpuGraph.captures == 1
    assert not torch.equal(want_a, want_b)
    for out, want in zip(got, (want_a, want_b, want_a)):
        assert isinstance(out, torch.Tensor) and torch.equal(out, want)


@pytest.mark.parametrize("change", ["content_batch", "adain_strides",
                                    "tap3_strides", "tap0_shape",
                                    "pyramid_tuple"])
def test_the_key_covers_every_tensor_and_the_pyramid(gen, as_card, change):
    dec = gen.dec
    content, adain, pyramid = dec_args(gen, 2)
    if change == "content_batch":
        other = dec_args(gen, 3)
    elif change == "adain_strides":     # the same values, column-major
        other = (content, adain.t().contiguous().t(), pyramid)
    elif change == "tap3_strides":
        taps = list(pyramid)
        # the encoder's taps are channels-last: the same values in NCHW
        taps[3] = taps[3].contiguous()
        assert taps[3].stride() != pyramid[3].stride()
        other = (content, adain, taps)
    elif change == "tap0_shape":      # a tap the decoder does not read
        other = (content, adain, [pyramid[0][..., :-1], *pyramid[1:]])
    else:
        other = (content, adain, tuple(pyramid))
    with torch.inference_mode():
        dec(content, adain, pyramid)
        got = dec(*other)
        want = eager(dec, *other)
    sigs = cuda_graphs.signatures(dec)
    assert CpuGraph.captures == 2 and len(sigs) == 2
    assert sigs[0] != sigs[1]
    assert torch.equal(got, want)


class Toy(nn.Module):
    """A forward of a tensor, a list of tensors and two non-tensors."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward(self, x, taps, scale, mode):
        y = x * self.w * scale + sum(torch.as_tensor(t).sum() for t in taps)
        return y if mode == "one" else [y, -y]


ToyGraphed = cuda_graphs.replay_eval_forward("toy", max_graphs=3)(
    type("ToyGraphed", (Toy,), {}))


def test_the_key_holds_the_non_tensor_arguments(as_card):
    toy = ToyGraphed().eval()
    x, taps = torch.arange(3.0), [torch.ones(2), torch.ones(1)]
    with torch.inference_mode():
        outs = [toy(x, taps, 2.0, "one"), toy(x, taps, 3.0, "one"),
                toy(x, taps, 2.0, "two"), toy(x, taps, 2.0, "one")]
        assert CpuGraph.captures == 3
        assert [s[2:] for s in cuda_graphs.signatures(toy)] == [
            (("value", 3.0), ("value", "one")),
            (("value", 2.0), ("value", "two")),
            (("value", 2.0), ("value", "one"))]
        # a value that cannot key a graph, and arguments by name: eager
        toy(x, taps, 2.0, ["one"])
        toy(x, taps, 2.0, mode="one")
        toy(x, [x, 1.0], 2.0, "one")
    assert CpuGraph.captures == 3
    assert torch.equal(outs[0], x * 2 + 3) and torch.equal(outs[3], outs[0])
    assert torch.equal(outs[1], x * 3 + 3)
    assert isinstance(outs[2], list) and torch.equal(outs[2][1], -(x * 2 + 3))


@pytest.mark.parametrize("case", ["train_no_grad", "eval_grad", "quant",
                                  "op_counts"])
def test_train_grad_quant_and_dispatch_modes_run_eager(gen, as_card, case):
    dec = gen.dec
    args = dec_args(gen, 2)
    if case == "train_no_grad":
        gen.train()
        with torch.no_grad():
            dec(*args)
    elif case == "eval_grad":
        dec(*args)
    elif case == "quant":
        dec.set_quant_mode("dynamic")
        with torch.inference_mode():
            got = dec(*args)
            assert torch.equal(got, eager(dec, *args))
    else:       # a dispatch mode counts the eager forward's ops
        with torch.inference_mode():
            counts = op_counts(dec, *args)
        assert counts["flops"] > 0 and counts["bytes"] > 0
    assert CpuGraph.captures == 0
    assert cuda_graphs.signatures(dec) == []


def test_hooks_on_the_decoder_fire_once_a_call(gen, as_card):
    dec = gen.dec
    seen = {"pre": 0, "post": []}

    def pre(module, args):
        seen["pre"] += 1

    def post(module, args, out):
        seen["post"].append(out)

    handles = [dec.register_forward_pre_hook(pre),
               dec.register_forward_hook(post)]
    try:
        with torch.inference_mode():
            outs = [dec(*dec_args(gen, 2, seed=s)) for s in range(3)]
    finally:
        for h in handles:
            h.remove()
    assert CpuGraph.captures == 1
    assert seen["pre"] == 3
    assert len(seen["post"]) == 3
    assert all(h is o for h, o in zip(seen["post"], outs))


def test_outputs_of_a_call_survive_the_next(gen, as_card):
    dec = gen.dec
    a, b = dec_args(gen, 3, seed=0), dec_args(gen, 3, seed=1)
    with torch.inference_mode():
        want_a = eager(dec, *a).clone()
        first = dec(*a)
        second = dec(*b)
    static = cuda_graphs._GRAPHS[dec][next(iter(cuda_graphs._GRAPHS[dec]))]
    assert first.data_ptr() != static.outputs.data_ptr()
    assert torch.equal(first, want_a)
    assert not torch.equal(first, second)


@pytest.mark.parametrize("then, kept", [
    ("eval", True), ("same_quant_mode", True), ("train_eval", False),
    ("to", False), ("quant_mode", True)])
def test_graphs_kept_or_dropped(gen, as_card, then, kept):
    dec = gen.dec
    args = dec_args(gen, 2)
    with torch.inference_mode():
        dec(*args)
    sig = cuda_graphs.signatures(dec)
    assert len(sig) == 1
    if then == "eval":
        gen.eval()
        dec.eval()
    elif then == "same_quant_mode":
        dec.set_quant_mode(None)
    elif then == "train_eval":
        gen.train()
        gen.eval()
    elif then == "to":
        gen.to("cpu")
    else:   # w8a8 serving's calls between float calls (gen_fn_in_mode)
        with torch.inference_mode():
            want = eager(dec, *args)
            for mode in ("dynamic", "calib", "static"):
                dec.set_quant_mode(mode)
                try:
                    out = dec(*args)
                finally:
                    dec.set_quant_mode(None)
                # calib runs the float convs and records each site's amax
                assert torch.equal(out, want) == (mode == "calib")
    assert cuda_graphs.signatures(dec) == (sig if kept else [])
    with torch.inference_mode():
        got = dec(*args)
        assert torch.equal(got, eager(dec, *args))
    assert CpuGraph.captures == (1 if kept else 2)


def test_the_cap_is_read_from_the_class(as_card, monkeypatch):
    monkeypatch.setattr(ToyGraphed, "MAX_GRAPHS", 2)
    toy = ToyGraphed().eval()
    x, taps = torch.arange(3.0), [torch.ones(2)]
    with torch.inference_mode():
        for scale in (1.0, 2.0, 3.0):
            toy(x, taps, scale, "one")
    assert CpuGraph.captures == 3
    assert [s[2] for s in cuda_graphs.signatures(toy)] == [
        ("value", 2.0), ("value", 3.0)]


def test_a_second_eval_keeps_the_style_encoders_graphs(gen, as_card):
    enc = gen.enc_image
    x = torch.as_tensor(stacks(small_config(), 1)[0]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        enc(x)
    sig = cuda_graphs.signatures(enc)
    gen.eval()
    enc.eval()
    assert cuda_graphs.signatures(enc) == sig and len(sig) == 1
    with torch.inference_mode():
        enc(x)
    assert CpuGraph.captures == 1


def test_the_cap_holds_the_preview_sizes_and_the_bulk_batch(gen, as_card):
    dec = gen.dec
    args = {n: dec_args(gen, n, seed=n) for n in SIZES}
    with torch.inference_mode():
        for _ in range(2):
            got = {n: dec(*a) for n, a in args.items()}
        assert CpuGraph.captures == len(SIZES) <= Decoder.MAX_GRAPHS
        assert [s[0][0][0] for s in cuda_graphs.signatures(dec)] == SIZES
        for n, a in args.items():
            assert torch.equal(got[n], eager(dec, *a))


def test_the_eval_step_keeps_its_graphs_across_calls(as_card):
    from affganwriting_torch.train.eval_step import make_eval_step
    from affganwriting_torch.train.state import init_state

    cfg = small_config(dis_layers=5, num_writers=8)
    rng = np.random.default_rng(7)

    def labels():
        ids = rng.integers(3, cfg.vocab_size, size=(2, cfg.output_max_len))
        ids[:, 0], ids[:, 5], ids[:, 6:] = 0, 1, 2
        return ids.astype(np.int32)

    batch = {"style_imgs": np.concatenate(stacks(cfg, 2, seed=2)),
             "label_xt": labels(), "label_xt_swap": labels(),
             "writer_ids": rng.integers(0, 8, 2).astype(np.int32)}
    state = init_state(cfg, device="cpu", seed=1, rec_dropout=0.0)
    step = make_eval_step(cfg, device="cpu")
    first = step(state, batch)
    second = step(state, batch)
    gen = state.gen.model
    assert CpuGraph.captures == 2           # the encoder's and the decoder's
    assert len(cuda_graphs.signatures(gen.enc_image)) == 1
    assert len(cuda_graphs.signatures(gen.dec)) == 1
    for a, b in zip(first[2].values(), second[2].values()):
        assert torch.equal(a, b)


def test_run_uploads_the_labels_once(monkeypatch):
    cfg = small_config()
    run = make_generate_and_read_fn(cfg, device="cpu", seed=3)
    labels = encode_labels(WORDS, cfg.output_max_len)
    uploads, seen = [], {}
    real = torch.as_tensor

    def as_tensor(data, *a, **kw):
        if data is labels:
            uploads.append(kw.get("device"))
        return real(data, *a, **kw)

    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    def keep(name, i):
        def hook(module, args):
            seen[name] = args[i]
        return hook

    handles = [run.gen.text_encoder.register_forward_pre_hook(keep("gen", 0)),
               run.rec.register_forward_pre_hook(keep("rec", 1))]
    try:
        images, ids = run(stacks(cfg, 1)[0], labels)
    finally:
        for h in handles:
            h.remove()
    assert uploads == [torch.device("cpu")]
    assert isinstance(seen["rec"], torch.Tensor)
    assert seen["rec"] is seen["gen"]
    assert seen["rec"].dtype == torch.long
    assert torch.equal(seen["rec"], torch.from_numpy(labels).long())
    assert tuple(ids.shape) == (len(WORDS), cfg.output_max_len - 1)


# --- on the card ------------------------------------------------------


def card_gen(dev):
    return lecun_init(build_generator(default_config(), dev, seed=0),
                      5).eval().requires_grad_(False)


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
def test_card_decoder_replay_is_the_eager_forward_bit_for_bit(n, card):
    gen = card_gen(card)
    dec = gen.dec
    a, b = dec_args(gen, n, seed=0, dev=card), dec_args(gen, n, seed=1,
                                                        dev=card)
    with torch.inference_mode():
        want_a = eager(dec, *a).clone()
        want_b = eager(dec, *b).clone()
        first = dec(*a)                 # captures, then replays
        second = dec(*b)
        third = dec(*a)
    torch.cuda.synchronize()
    assert tuple(first.shape) == (n, 1, SERVE_H, SERVE_W)
    assert torch.isfinite(want_a.float()).all()
    assert not torch.equal(want_a, want_b)
    assert len(cuda_graphs.signatures(dec)) == 1
    assert torch.equal(first, want_a)
    assert torch.equal(second, want_b)
    assert torch.equal(third, want_a)


@pytest.mark.card
def test_card_float_call_after_an_int8_call_replays(card):
    gen = card_gen(card)
    dec = gen.dec
    args = dec_args(gen, BULK, dev=card)
    with torch.inference_mode():
        want = eager(dec, *args).clone()
        dec(*args)                      # captures
        dec.set_quant_mode("dynamic")
        try:
            int8 = dec(*args)
        finally:
            dec.set_quant_mode(None)
        graphs = dict(cuda_graphs._GRAPHS[dec])
        got = dec(*args)
    torch.cuda.synchronize()
    assert dict(cuda_graphs._GRAPHS[dec]) == graphs and len(graphs) == 1
    assert not torch.equal(int8, want)
    assert torch.equal(got, want)


@pytest.mark.card
def test_card_generate_and_read_is_the_eager_run_bit_for_bit(card,
                                                            monkeypatch):
    cfg = default_config()
    run = make_generate_and_read_fn(cfg, device=card, seed=0)
    style = card_stacks(card, 2)
    labels = [encode_labels(words(BULK, s), cfg.output_max_len)
              for s in (0, 1)]
    got = [run(style[i].cpu().numpy(), labels[i]) for i in (0, 1, 0)]
    assert len(cuda_graphs.signatures(run.gen.dec)) == 1
    with monkeypatch.context() as m:
        m.setattr(cuda_graphs, "_on_card", lambda tensors: False)
        want = [run(style[i].cpu().numpy(), labels[i]) for i in (0, 1)]
    torch.cuda.synchronize()
    assert not torch.equal(want[0][0], want[1][0])
    for (imgs, ids), (w_imgs, w_ids) in zip(got, want + want[:1]):
        assert torch.equal(imgs, w_imgs)
        assert torch.equal(ids, w_ids)


@pytest.mark.card
def test_card_profiled_request_replays_the_decoder_with_its_kernels(
        card, tmp_path):
    cfg = default_config()
    run = make_generate_and_read_fn(cfg, device=card, seed=0)
    args = (card_stacks(card, 1)[0].cpu().numpy(),
            encode_labels(words(BULK), cfg.output_max_len))
    run(*args)                          # captures both graphs
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(*args)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (s0, e0, _), = [sp for sp in spans if sp[2] == "G.dec"]
    held = [n for s, e, n in spans if s0 <= s and e <= e0 and n != "G.dec"]
    assert held == ["G.dec.replay"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("in_relu" in k for k in kernels) == 2
    assert sum("phase_head_wgmma" in k for k in kernels) == 1
