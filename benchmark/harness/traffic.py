"""The one traffic generator: every mix is a data file of parameters.

``kind`` picks the loop that offers the load (``closed``: one client sends
its next request when the last came back; ``open``: Poisson arrivals at
``rate_per_s``; ``train``: batches into the train step); the sizes are
``writers`` (the style pool), ``words_min``/``words_max`` (words a request,
uniform) or ``batch`` (rows a step over all cards).

So that the seed changes the order of the work and not its amount, an open
mix draws its sizes and gaps once from ``shape_seed`` and the run's seed
only permutes them; a closed mix's requests all have one size.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness import data

E2E = {"closed": "words_per_s", "open": "request_p95_ms",
       "train": "train_words_per_s"}


@dataclasses.dataclass
class Request:
    index: int
    at: float            # seconds after the window opens that it is due
    writer: int          # row of the style pool
    words: list


def _words(rng, vocab, n):
    return [vocab[j] for j in rng.integers(len(vocab), size=n)]


def closed(mix: dict, seed: int, vocab: list[str]):
    """An endless stream of requests, each a pool writer x ``words_max``."""
    rng = np.random.default_rng([seed, 2])
    n, i = mix["words_max"], 0
    while True:
        order = rng.permutation(mix["writers"])
        for w in order:
            yield Request(i, 0.0, int(w), _words(rng, vocab, n))
            i += 1


def open_schedule(mix: dict, seed: int, seconds: float,
                  vocab: list[str]) -> list[Request]:
    """The requests due in a window of ``seconds``."""
    shape = np.random.default_rng([mix["shape_seed"], 3])
    count = int(mix["rate_per_s"] * seconds * 2) + 16
    gaps = shape.exponential(1.0 / mix["rate_per_s"], count)
    sizes = shape.integers(mix["words_min"], mix["words_max"] + 1, count)
    keep = int(np.searchsorted(np.cumsum(gaps), seconds))
    gaps, sizes = gaps[:keep], sizes[:keep]
    rng = np.random.default_rng([seed, 3])
    perm = rng.permutation(keep)
    ats = np.cumsum(gaps[rng.permutation(keep)])
    return [Request(i, float(ats[i]), int(rng.integers(mix["writers"])),
                    _words(rng, vocab, int(sizes[perm[i]])))
            for i in range(keep)]


def train_batches(mix: dict, seed: int, pool, vocab: list[str], cfg: dict):
    """An endless stream of train batches in the step's layout: ``batch``
    writers of the pool, each stack in a new order, channel 0's word as
    ``label_ch0``, two corpus words as the targets (``oov``)."""
    rng = np.random.default_rng([seed, 4])
    b, t = mix["batch"], cfg["max_chars"] + 2
    while True:
        rows = rng.choice(len(pool.ids), b, replace=False)
        order = [rng.permutation(cfg["style_stack"]) for _ in rows]
        style = np.stack([pool.stacks[r][..., o] for r, o in zip(rows, order)])
        ch0 = [pool.words[r][o[0]] for r, o in zip(rows, order)]
        yield {"style_imgs": np.ascontiguousarray(style),
               "label_ch0": data.encode_labels(ch0, t),
               "label_xt": data.encode_labels(_words(rng, vocab, b), t),
               "label_xt_swap": data.encode_labels(_words(rng, vocab, b), t),
               "writer_ids": pool.ids[rows].astype(np.int64)}
