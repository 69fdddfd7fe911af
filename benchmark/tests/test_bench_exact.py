"""Finding the reference's parts by name changed no number: the weights
drawn for every player of both configurations, the FLOPs of a request and
of a step, and the judges' numbers of the tiny synth and train cells fed
fixed outputs, all equal to what the single-module reference gave.

The constants were recorded on the commit before the parts moved into
files of their own, by this file's functions (``python -m
benchmark.tests.test_bench_exact`` prints them)."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark.harness import data, flops, spec, traffic, weights
from benchmark.harness import serve as S
from benchmark.harness import train as T
from benchmark.reference import models as ref
from benchmark.reference import step as rstep
from benchmark.tests import tiny

CPU = torch.device("cpu")
CONFIGS = ("affgan-word-resnet50", "affgan-word-dinov2l")
SEEDS = (5, 3000000019)

DIGESTS = {
    "affgan-word-dinov2l/cla/3000000019": "5483abe6f697753f",
    "affgan-word-dinov2l/cla/5": "06197159f2b01e1e",
    "affgan-word-dinov2l/dis/3000000019": "8f46127b00de53f2",
    "affgan-word-dinov2l/dis/5": "4bd43d04d148edf6",
    "affgan-word-dinov2l/gen/3000000019": "8586ef17bba6e9e5",
    "affgan-word-dinov2l/gen/5": "e3438cfb89ff7f34",
    "affgan-word-dinov2l/rec/3000000019": "c8f9500a69cf2ca5",
    "affgan-word-dinov2l/rec/5": "8e42890481d24eb3",
    "affgan-word-resnet50/cla/3000000019": "5483abe6f697753f",
    "affgan-word-resnet50/cla/5": "06197159f2b01e1e",
    "affgan-word-resnet50/dis/3000000019": "8f46127b00de53f2",
    "affgan-word-resnet50/dis/5": "4bd43d04d148edf6",
    "affgan-word-resnet50/gen/3000000019": "a37445892ba07989",
    "affgan-word-resnet50/gen/5": "999394b434a78c64",
    "affgan-word-resnet50/rec/3000000019": "c8f9500a69cf2ca5",
    "affgan-word-resnet50/rec/5": "8e42890481d24eb3",
}
FLOPS = {
    "affgan-word-dinov2l/serve/1": 73143985920.0,
    "affgan-word-dinov2l/serve/128": 2860039496192.0,
    "affgan-word-dinov2l/serve/8": 226752399872.0,
    "affgan-word-dinov2l/train/8": 2731021686784.0,
    "affgan-word-resnet50/serve/1": 26140878592.0,
    "affgan-word-resnet50/serve/128": 2813036388864.0,
    "affgan-word-resnet50/serve/8": 179749292544.0,
    "affgan-word-resnet50/train/8": 1602088589312.0,
}
SERVE_NUMBERS = {
    "image_err": 1.3126219511032104,
    "image_rel": 1.2964065936704694,
    "logit_err": 18.398534774780273,
    "logit_rel": 18.976291551904087,
    "style_rel": 2.564295110534385,
    "token_gap": 0.33171799778938293,
}
TRAIN_NUMBERS = {
    "cla_rel": 1.0179545879364014,
    "delta_err": 935.6436297095821,
    "delta_med": 7.362974625584119,
    "dis_rel": 1.0906990766525269,
    "fake_rel": 2.322488784790039,
    "grad_err": 1.003289490216643,
    "grad_med": 0.7111521027396268,
    "loss1_err": 3.8511464116800327,
    "loss_err": 5.885538463734635,
    "rec_rel": 4.079963684082031,
}


@pytest.fixture
def one_thread():
    """One CPU thread, so that no sum depends on how work is split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(cfg: dict, player: str, seed: int) -> str:
    h = hashlib.sha256()
    for k, v in weights.draw(cfg, player, seed, CPU).items():
        h.update(f"{k}{tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def weight_digests() -> dict:
    return {f"{c}/{p}/{s}": digest(spec.config(c)["config"], p, s)
            for c in CONFIGS for p in rstep.PLAYERS for s in SEEDS}


def flop_counts() -> dict:
    out = {}
    for c in CONFIGS:
        cfg = spec.config(c)["config"]
        for n in (1, 8, 128):
            out[f"{c}/serve/{n}"] = flops.serve(cfg, n)
        out[f"{c}/train/8"] = flops.train(cfg, 8)
    return out


def _pyramid_shapes(cfg: dict):
    with torch.device("meta"):
        g = ref.build(cfg, "gen").eval()
        pyr = g.encode_style(torch.empty(1, cfg["img_height"],
                                         cfg["img_width"], cfg["style_stack"]))
    return [tuple(p.shape) for p in pyr]


def serve_numbers(seed: int = 23) -> dict:
    """``serve.judge`` of the tiny synth cell over two fabricated
    requests: images, ids, logits and style taps drawn from ``seed``."""
    cell = tiny.synth()
    cfg = cell["config_file"]["config"]
    pool = data.StylePool(seed, cfg, cell["traffic_mix"]["writers"], CPU)
    g = torch.Generator().manual_seed(seed)
    steps = cfg["max_chars"] + 1
    shapes = _pyramid_shapes(cfg)
    vocab = data.corpus(cfg["max_chars"])
    outputs = []
    for i, n in enumerate((4, 3)):
        req = traffic.Request(i, 0.0, i % len(pool.ids),
                              vocab[5 * i:5 * i + n])
        imgs = torch.rand(n, cfg["img_height"], cfg["img_width"],
                          generator=g) * 2 - 1
        ids = torch.randint(0, 55, (n, steps), generator=g)
        logits = torch.randn(n, steps, 55, generator=g)
        taps = [torch.randn(shapes[k], generator=g) for k in (3, 4)]
        outputs.append((req, imgs, ids, logits, taps))
    return S.judge(cfg, seed, CPU, pool, outputs)


def _first_shapes(cfg: dict, b: int) -> dict:
    h, w = cfg["img_height"], cfg["img_width"]
    with torch.device("meta"):
        d = ref.build(cfg, "dis")(torch.empty(b, 1, h, w))
        c = ref.build(cfg, "cla")(torch.empty(b, 1, h, w))
    return {"fake": (b, 1, h, w), "dis": tuple(d.shape),
            "dis_ch1": tuple(d.shape), "cla": tuple(c.shape),
            "rec": (b, cfg["max_chars"] + 1, 55)}


def train_numbers(seed: int = 29) -> dict:
    """``train.judge`` of the tiny train cell's checked steps, the
    program's readings fabricated from ``seed``."""
    cell = tiny.train()
    cfg, mix = cell["config_file"]["config"], cell["traffic_mix"]
    pool = data.StylePool(seed, cfg, mix["writers"], CPU)
    batches = traffic.train_batches(mix, seed, pool,
                                    data.corpus(cfg["max_chars"]), cfg)
    checked = [next(batches) for _ in range(T.CHECK_STEPS)]
    g = torch.Generator().manual_seed(seed)
    b, steps = mix["batch"], cfg["max_chars"] + 1
    keys = sorted(f"{p}.{k}" for p in rstep.PLAYERS
                  for k in weights.shapes(cfg, p))

    def leaf_values():
        return dict(zip(keys, torch.rand(len(keys), generator=g).tolist()))

    prog = {
        "loss": [dict(zip(T.LOSSES, (torch.rand(4, generator=g) * 10)
                          .tolist())) for _ in range(T.CHECK_STEPS)],
        "grad": leaf_values(), "delta": leaf_values(),
        "first": {n: torch.randn(s, generator=g)
                  for n, s in _first_shapes(cfg, b).items()},
        "feeds": [tuple(torch.randint(0, 55, (b, steps), generator=g)
                        for _ in range(3)) for _ in range(T.CHECK_STEPS)]}
    return T.judge(cfg, seed, CPU, checked, prog)


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_weights_are_unchanged(key):
    c, p, s = key.split("/")
    assert digest(spec.config(c)["config"], p, int(s)) == DIGESTS[key]


def test_flops_are_unchanged():
    assert flop_counts() == FLOPS


def test_serve_judge_is_unchanged(one_thread):
    assert serve_numbers() == SERVE_NUMBERS


def test_train_judge_is_unchanged(one_thread):
    assert train_numbers() == TRAIN_NUMBERS


if __name__ == "__main__":
    torch.set_num_threads(1)
    for name, f in (("DIGESTS", weight_digests), ("FLOPS", flop_counts),
                    ("SERVE_NUMBERS", serve_numbers),
                    ("TRAIN_NUMBERS", train_numbers)):
        print(f"{name} = {f()!r}")
