"""The style encoder's eval forward replayed as CUDA graphs
(``utils/cuda_graphs.py``, applied by ``models/style_encoders/register``).

On the CPU: which calls replay (eval mode, grad off, no dispatch mode, a
CUDA input) and which stay eager; the graph cache (signatures, least recently used out,
dropped by ``train()`` then ``eval()`` and ``.to()``); hooks on the encoder
firing once a call; outputs kept across calls; the capture and replay
spans of a request, the decoder's beside the encoder's.  The CPU has no
CUDA graphs, so the cache tests stand a CPU graph in for the captured one
(``CpuGraph``, which ``test_torch_decoder_graph.py`` shares): it runs the
real static inputs and replay path (copy in, replay, clone out), its
replay recomputing the forward into the static outputs.

On the card (``card``; skips without one): every registered encoder at
the serving shape, and ``Generator.encode_style`` as ``generate_images``
calls it, replays bit for bit as its eager forward, on two stacks, with
the first call's outputs intact after the next; the train step launches
the same kernels before and after G's encoder has been captured.  This
file imports no JAX; on the card:
``python -m pytest --noconftest tests/test_torch_style_graph.py -m card``.
"""

import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

from affganwriting_torch.core.config import default_config
from affganwriting_torch.gen.inference import (
    build_generator,
    encode_labels,
    generate_images,
    make_generate_and_read_fn,
)
from affganwriting_torch.models.blocks import frozen_stats
from affganwriting_torch.models.style_encoders import (
    _REGISTRY,
    available,
    get_style_encoder,
)
from affganwriting_torch.utils import cuda_graphs
from affganwriting_torch.utils.profiling import op_counts

torch.set_num_threads(2)   # tier-1 runs six xdist workers

# the small fp32 resnet50 configuration of the CPU tests
SMALL = dict(compute_dtype="float32", img_height=32, img_width=104,
             max_chars=6, style_dim=64, adain_param_dim=512,
             text_embed_dim=16, rec_hidden=64, rec_embed=16)
WORDS = ["deep", "tpu", "Hopper", "kernel"]


def small_config(**kw):
    return default_config().replace(**{**SMALL, **kw})


def stacks(cfg, n, seed=0):
    """``n`` style stacks (1, H, W, 50) as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
            for _ in range(n)]


def nchw(stack, dev="cpu"):
    """The view ``Generator.encode_style`` hands the encoder."""
    return torch.as_tensor(stack, device=dev).permute(0, 3, 1, 2)


def as_list(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


class CpuGraph(cuda_graphs._Graph):
    """A CPU stand-in for the captured graph: ``_Graph``'s own static
    inputs and replay (copy in, replay, clone out), the capture running the
    forward once and the replay recomputing it from the static inputs into
    the static outputs, as the graph's kernels do, with the program's spans
    off, as a replay opens none inside."""

    captures = 0

    def _capture(self, forward):
        type(self).captures += 1

        def replay():
            with mock.patch.object(torch.autograd, "_profiler_enabled",
                                   lambda: False):
                new = forward(*self.args)
            for out, n in zip(as_list(self.outputs), as_list(new)):
                out.copy_(n)
        self.graph = types.SimpleNamespace(replay=replay)
        return forward(*self.args)


@pytest.fixture
def as_card(monkeypatch):
    """CPU inputs count as the card's, with ``CpuGraph`` for the graph."""
    monkeypatch.setattr(cuda_graphs, "_on_card", lambda x: True)
    monkeypatch.setattr(cuda_graphs, "_Graph", CpuGraph)
    monkeypatch.setattr(CpuGraph, "captures", 0)


@pytest.fixture
def gen():
    return build_generator(small_config(), "cpu", seed=3)


def eager(enc, x):
    return type(enc).forward.__wrapped__(enc, x)


def test_every_registered_encoder_replays_through_one_path():
    assert available() == sorted(_REGISTRY)
    for name in available():
        cls = _REGISTRY[name]
        assert cls.forward.__wrapped__.__name__ == "forward", name
        assert cls.train.__module__ == cuda_graphs.__name__, name
        assert cls._apply.__module__ == cuda_graphs.__name__, name


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_cpu_input_runs_eager_and_keeps_no_graph(gen, mode):
    enc = gen.enc_image
    x = nchw(stacks(small_config(), 1)[0])
    with getattr(torch, mode)():
        want = eager(enc, x)
        got = enc(x)
    assert cuda_graphs.signatures(enc) == []
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["train_no_grad_frozen_stats", "train_grad",
                                  "eval_grad", "eval_op_counts"])
def test_train_mode_and_grad_run_eager(gen, as_card, case):
    enc = gen.enc_image
    x = nchw(stacks(small_config(), 1)[0])
    if case == "train_no_grad_frozen_stats":
        stats = {k: v.clone() for k, v in enc.state_dict().items()}
        gen.train()
        with torch.no_grad(), frozen_stats(gen):
            enc(x)
        assert all(torch.equal(v, stats[k])
                   for k, v in enc.state_dict().items())
    elif case == "train_grad":
        gen.train()
        enc(x)
    elif case == "eval_grad":
        enc(x)
    else:       # a dispatch mode counts the eager forward's ops
        with torch.inference_mode():
            counts = op_counts(enc, x)
        assert counts["flops"] > 0 and counts["bytes"] > 0
    assert CpuGraph.captures == 0
    assert cuda_graphs.signatures(enc) == []


def test_replays_each_signature_and_keeps_the_newest(gen, as_card):
    enc = gen.enc_image
    cfg = small_config()
    a, b = (nchw(s) for s in stacks(cfg, 2))
    with torch.inference_mode():
        want_a, want_b = eager(enc, a), eager(enc, b)
        got = [enc(a), enc(b), enc(a)]
        assert CpuGraph.captures == 1
        assert cuda_graphs.signatures(enc) == [
            (((1, 50, 32, 104), a.stride(), torch.float32, a.device),)]
        # a contiguous input and batches of 2, 3 and 4: other signatures
        others = [a.contiguous()] + [torch.cat([b] * n) for n in (2, 3, 4)]
        for x in others:
            enc(x)
        assert CpuGraph.captures == 5
        sigs = cuda_graphs.signatures(enc)
        assert len(sigs) == type(enc).MAX_GRAPHS == 4
        assert (a.shape, a.stride()) not in [s[0][:2] for s in sigs]  # oldest
        enc(others[1])                                   # used: newest
        assert cuda_graphs.signatures(enc)[-1][0][0] == (2, 50, 32, 104)
        assert CpuGraph.captures == 5
    for out, want in zip(got, (want_a, want_b, want_a)):
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_outputs_of_a_call_survive_the_next(gen, as_card):
    enc = gen.enc_image
    a, b = (nchw(s) for s in stacks(small_config(), 2, seed=1))
    with torch.inference_mode():
        want_a = [t.clone() for t in eager(enc, a)]
        first = enc(a)
        second = enc(b)
    static = cuda_graphs._GRAPHS[enc][next(iter(cuda_graphs._GRAPHS[enc]))]
    assert all(f.data_ptr() != s.data_ptr()
               for f, s in zip(first, static.outputs))
    assert all(torch.equal(f, w) for f, w in zip(first, want_a))
    assert not torch.equal(first[-1], second[-1])


def test_hooks_on_the_encoder_fire_once_a_call(gen, as_card):
    enc = gen.enc_image
    seen = {"pre": 0, "post": []}

    def pre(module, args):
        seen["pre"] += 1

    def post(module, args, out):
        seen["post"].append(out)

    handles = [enc.register_forward_pre_hook(pre),
               enc.register_forward_hook(post)]
    try:
        with torch.inference_mode():
            outs = [enc(nchw(s)) for s in stacks(small_config(), 3)]
    finally:
        for h in handles:
            h.remove()
    assert CpuGraph.captures == 1
    assert seen["pre"] == 3
    assert len(seen["post"]) == 3
    assert all(h is o for h, o in zip(seen["post"], outs))


@pytest.mark.parametrize("drop", ["train", "to"])
def test_train_and_to_drop_the_graphs(gen, as_card, drop):
    enc = gen.enc_image
    x = nchw(stacks(small_config(), 1)[0])
    with torch.inference_mode():
        enc(x)
    assert len(cuda_graphs.signatures(enc)) == 1
    if drop == "train":
        gen.train()
        gen.eval()
    else:
        gen.to("cpu")
    assert cuda_graphs.signatures(enc) == []
    with torch.inference_mode():
        enc(x)
    assert CpuGraph.captures == 2


def program_spans(run, args, path):
    """``run(*args)``'s result and the program's spans it opened, (start,
    end, name) with an outer span before an inner one that starts with
    it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run(*args)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(("G", "R", "serve."))),
                   key=lambda sp: (sp[0], -sp[1]))
    return out, spans


def test_a_request_opens_capture_then_replay_spans(as_card, tmp_path):
    cfg = small_config()
    run = make_generate_and_read_fn(cfg, device="cpu", seed=3)
    args = (stacks(cfg, 1)[0], encode_labels(WORDS, cfg.output_max_len))
    first, spans1 = program_spans(run, args, tmp_path / "1.json")
    second, spans2 = program_spans(run, args, tmp_path / "2.json")
    assert CpuGraph.captures == 2         # the encoder's and the decoder's
    # the decoder's replay stands for its three spans, which open in its
    # capture
    dec_spans = ["G.dec.res", "G.dec.up", "G.dec.head"]
    for spans, inner, count in ((spans1, ["G.encode_style.capture",
                                          "G.encode_style.replay"], 17),
                                (spans2, ["G.encode_style.replay"], 12)):
        names = [n for _, _, n in spans]
        assert len(names) == count
        (s0, e0, _), = [sp for sp in spans if sp[2] == "G.encode_style"]
        held = [n for s, e, n in spans if s0 <= s and e <= e0
                and n != "G.encode_style"]
        assert held == inner
        (s0, e0, _), = [sp for sp in spans if sp[2] == "G.dec"]
        held = [n for s, e, n in spans if s0 <= s and e <= e0
                and n != "G.dec"]
        assert held == (["G.dec.capture", *dec_spans, "G.dec.replay"]
                        if count == 17 else ["G.dec.replay"])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# --- on the card ------------------------------------------------------

SERVE_H, SERVE_W = 64, 216     # default_config()'s word images


def lecun_init(module, seed):
    """LeCun-normal weights drawn on the module's device, norm scales 1,
    biases 0 (``gen/inference.init_weights``, without the CPU draw)."""
    dev = next(module.parameters()).device
    g = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.normal_(generator=g).div_(p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module


def card_stacks(dev, n):
    g = torch.Generator(dev).manual_seed(11)
    return [torch.rand(1, SERVE_H, SERVE_W, 50, generator=g, device=dev)
            for _ in range(n)]


def same(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", available())
def test_card_replay_is_the_eager_forward_bit_for_bit(name, card):
    with torch.device(card):
        enc = get_style_encoder(name, in_channels=50,
                                final_hw=(SERVE_H // 8, SERVE_W // 8),
                                dtype=torch.bfloat16)
    enc = lecun_init(enc, 5).eval().requires_grad_(False)
    a, b = (s.permute(0, 3, 1, 2) for s in card_stacks(card, 2))
    with torch.inference_mode():
        want_a = [t.clone() for t in eager(enc, a)]
        want_b = [t.clone() for t in eager(enc, b)]
        first = enc(a)                  # captures, then replays
        second = enc(b)                 # replays the other stack
        third = enc(a)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.float()).all() for t in want_a + want_b)
    assert not same(want_a, want_b)
    assert len(cuda_graphs.signatures(enc)) == 1
    assert same(first, want_a), name
    assert same(second, want_b), name
    assert same(third, want_a), name
    del enc
    torch.cuda.empty_cache()


@pytest.mark.card
def test_card_generate_images_replays_the_encoder_bit_for_bit(card):
    cfg = default_config()
    gen = build_generator(cfg, card, seed=0)
    labels = encode_labels(WORDS * 32, cfg.output_max_len)
    kept = []
    hook = gen.enc_image.register_forward_hook(
        lambda m, a, out: kept.append(out))
    styles = card_stacks(card, 2)
    try:
        with torch.inference_mode():
            imgs = [generate_images(gen, s, labels, card) for s in styles]
            want = [[t.clone() for t in eager(gen.enc_image,
                                              s.permute(0, 3, 1, 2))]
                    for s in styles]
            want_imgs = [gen.generate(w, torch.as_tensor(
                labels, device=card).long()).permute(0, 2, 3, 1)
                for w in want]
    finally:
        hook.remove()
    torch.cuda.synchronize()
    assert len(kept) == 2
    assert len(cuda_graphs.signatures(gen.enc_image)) == 1
    assert same(kept[0], want[0]) and same(kept[1], want[1])
    assert not same(kept[0], kept[1])
    assert torch.equal(imgs[0], want_imgs[0])
    assert torch.equal(imgs[1], want_imgs[1])


def step_kernels(step, state, batch, dev, path):
    """The kernels one train step launches and whether it replayed a
    graph, from its profiler trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch, torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    graphs = sum("GraphLaunch" in e.get("name", "") for e in events)
    return kernels, graphs


@pytest.mark.card
def test_card_train_step_launches_as_before_the_capture(card, tmp_path):
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.step import make_phased_train_step

    cfg = small_config(dis_layers=5, num_writers=8)
    rng = np.random.default_rng(7)

    def labels():
        ids = rng.integers(3, cfg.vocab_size, size=(4, cfg.output_max_len))
        ids[:, 0], ids[:, 5], ids[:, 6:] = 0, 1, 2
        return ids.astype(np.int32)

    batch = {"style_imgs": np.concatenate(stacks(cfg, 4, seed=2)),
             "label_ch0": labels(), "label_xt": labels(),
             "label_xt_swap": labels(),
             "writer_ids": rng.integers(0, 8, 4).astype(np.int32)}
    state = init_state(cfg, device=card, seed=1, rec_dropout=0.0)
    step = make_phased_train_step(cfg, merge_dg=False, device=card)
    for _ in range(2):
        step(state, batch, torch.Generator(card).manual_seed(0))
    before = step_kernels(step, state, batch, card, tmp_path / "a.json")
    gen = state.gen.model.eval()
    with torch.inference_mode():
        gen.encode_style(torch.as_tensor(batch["style_imgs"][:1],
                                         device=card))
    assert len(cuda_graphs.signatures(gen.enc_image)) == 1
    after = step_kernels(step, state, batch, card, tmp_path / "b.json")
    assert cuda_graphs.signatures(gen.enc_image) == []
    assert before[1] == after[1] == 0
    assert before[0] == after[0] > 0
