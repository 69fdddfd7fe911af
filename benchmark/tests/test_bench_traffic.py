"""Every input is a function of the seed alone, whatever
``PYTHONHASHSEED`` is."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import data, traffic
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]

DIGEST = r"""
import hashlib, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from benchmark.harness import data, traffic
from benchmark.tests import tiny
h = hashlib.sha256()
for cell in (tiny.synth(), tiny.preview(), tiny.train()):
    cfg, mix = cell["config_file"]["config"], cell["traffic_mix"]
    pool = data.StylePool(2 ** 33 + 5, cfg, mix["writers"], "cpu")
    h.update(pool.stacks.tobytes())
    vocab = data.corpus()
    if mix["kind"] == "closed":
        it = traffic.closed(mix, 2 ** 33 + 5, vocab)
        reqs = [next(it) for _ in range(8)]
    elif mix["kind"] == "open":
        reqs = traffic.open_schedule(mix, 2 ** 33 + 5, 5.0, vocab)
    else:
        it = traffic.train_batches(mix, 2 ** 33 + 5, pool, vocab, cfg)
        b = next(it)
        reqs = []
        for k in sorted(b):
            h.update(np.ascontiguousarray(b[k]).tobytes())
    for r in reqs:
        h.update(repr((r.at, r.writer, r.words)).encode())
print(h.hexdigest())
"""


def digest(hashseed: str) -> str:
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    return subprocess.run([sys.executable, "-c", DIGEST, str(ROOT)], env=env,
                          capture_output=True, text=True, check=True).stdout


def test_inputs_ignore_pythonhashseed():
    assert digest("0") == digest("12345")


def test_open_mix_permutes_one_set_of_sizes():
    """Two seeds offer the same requests' sizes and arrivals in another
    order, so the seed does not change the amount of work."""
    mix = tiny.preview()["traffic_mix"]
    vocab = data.corpus()
    a = traffic.open_schedule(mix, 1, 30.0, vocab)
    b = traffic.open_schedule(mix, 2, 30.0, vocab)
    assert sorted(len(r.words) for r in a) == sorted(len(r.words) for r in b)
    assert [r.at for r in a] != [r.at for r in b]
    assert a[-1].at == pytest.approx(b[-1].at)


def test_renderer_matches_the_port_but_for_the_seed(monkeypatch):
    """The benchmark's bulk renderer draws the port's strokes (the port's
    ``synthetic_word_image`` with its seed taken from ``zlib.crc32``)."""
    import zlib

    from affganwriting_torch.data import words as port_words

    word, writer = "Knights", 17
    mine = data.render([word], [writer], 64, 216, "cpu")[0].numpy()
    monkeypatch.setattr(port_words, "hash",
                        lambda w: zlib.crc32(w.encode()), raising=False)
    theirs = port_words.synthetic_word_image(word, writer)
    np.testing.assert_allclose(mine, theirs, atol=2e-5)


def test_labels_encode_go_letters_end_pad():
    lab = data.encode_labels(["ab", "Z"], 6)
    assert lab.tolist() == [[0, 3, 4, 1, 2, 2], [0, 54, 1, 2, 2, 2]]
    assert lab.dtype == np.int64 and torch.as_tensor(lab).dtype == torch.int64
