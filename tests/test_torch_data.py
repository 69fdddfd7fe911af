"""The port's data stream, CER, prefetch and image sheets vs the JAX
package's, on the CPU, in one process.

The synthetic word images seed from ``hash(word)``, which Python randomizes
per process, so the two packages' batches agree only inside one process:
every comparison here builds both in this one.  Tolerances: none.  The
batches, the CER counts, the word error rate, ``edits1`` and the
preprocessed images must be equal, bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import affganwriting_tpu.data.words as jwords
import affganwriting_tpu.eval.cer as jcer
import affganwriting_tpu.eval.sheets as jsheets
import affganwriting_tpu.utils.native as jnative
from affganwriting_tpu.data.iam import (
    default_reference_paths as j_paths,
    load_corpus as j_load_corpus,
    parse_groundtruth as j_parse,
    writer_label_map as j_label_map,
)
from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.data import iam, words
from affganwriting_torch.data.prefetch import prefetch
from affganwriting_torch.eval import cer, sheets
from affganwriting_torch.utils import native
from test_torch_support import small_jax_config, small_torch_config

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_ground_truth_and_corpus_read_as_the_jax_package_reads_them():
    """The port reads its own copy of the data files (``data/assets``),
    byte for byte the JAX package's, and parses them as it does."""
    import filecmp
    import os

    ours, theirs = iam.default_reference_paths(), j_paths()
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert "affganwriting_torch" in ours[k] and ours[k] != theirs[k]
        assert os.path.basename(ours[k]) == os.path.basename(theirs[k])
        assert filecmp.cmp(ours[k], theirs[k], shallow=False), k
    for split in ("train_gt", "test_gt"):
        a, b = iam.parse_groundtruth(ours[split]), j_parse(theirs[split])
        assert list(a) == list(b)
        assert [[tuple(vars(e).values()) for e in v] for v in a.values()] \
            == [[tuple(vars(e).values()) for e in v] for v in b.values()]
        assert iam.writer_label_map(a) == j_label_map(b)
    for c in ("corpus", "oov_corpus"):
        assert iam.load_corpus(ours[c]) == j_load_corpus(theirs[c])


def _datasets(oov: bool, seed: int):
    paths = iam.default_reference_paths()
    gt = dict(list(iam.parse_groundtruth(paths["train_gt"]).items())[:5])
    corpus = iam.load_corpus(paths["corpus"])[:500]
    jgt = dict(list(j_parse(paths["train_gt"]).items())[:5])
    port = words.WordStyleDataset(
        gt, iam.writer_label_map(gt), small_torch_config(oov=oov,
                                                         batch_size=2),
        corpus=corpus, seed=seed)
    ref = jwords.WordStyleDataset(
        jgt, j_label_map(jgt), small_jax_config(oov=oov, batch_size=2),
        corpus=corpus, seed=seed)
    return port, ref


@pytest.mark.parametrize("oov", [True, False], ids=["oov", "held_out"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "ordered"])
def test_batches_are_bit_equal(oov, shuffle):
    """Every key, dtype, shape and value of the batches of two epochs; 5
    writers at batch 2 with ``drop_last`` give two batches an epoch."""
    port, ref = _datasets(oov, seed=3)
    for epoch in (0, 1):
        got = list(port.batches(epoch=epoch, shuffle=shuffle))
        want = list(ref.batches(epoch=epoch, shuffle=shuffle))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(port) == len(ref) == 5


def test_edits1_matches():
    for word in ("a", "ab", "abc", "hello", "handwriting", "Zebra"):
        for seed in range(20):
            assert words.edits1(word, np.random.default_rng(seed),
                                max_len=10) == \
                jwords.edits1(word, np.random.default_rng(seed), max_len=10)


@pytest.fixture(scope="module")
def native_built():
    native.build(verbose=False)
    if not jnative.available():
        jnative.build(verbose=False)
    return native.available() and jnative.available()


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_preprocess_word_image_matches(native_built, use_native,
                                       monkeypatch):
    """uint8 images through the native library or the numpy version on
    both sides, and float images (always numpy)."""
    assert native_built
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(0)
    for h, w in ((40, 90), (120, 500), (64, 216), (20, 400)):
        img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        for x in (img, img.astype(np.float32) / 255.0):
            got = words.preprocess_word_image(x, 32, 104)
            want = jwords.preprocess_word_image(x, 32, 104)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def _padded_ids(rng, b, t):
    """Random (B, T) label rows: GO, letters, END, PAD, with control tokens
    also scattered inside some rows."""
    ids = rng.integers(3, VOCAB.size, size=(b, t))
    for i, n in enumerate(rng.integers(0, t - 1, size=b)):
        ids[i, 0] = 0
        ids[i, n + 1] = 1
        ids[i, n + 2:] = 2
    ids[rng.random((b, t)) < 0.05] = rng.integers(0, 3)
    return ids.astype(np.int32)


def test_cer_functions_are_exactly_equal():
    rng = np.random.default_rng(1)
    for b, t in ((1, 4), (7, 12), (33, 11), (16, 8)):
        pred, gt = _padded_ids(rng, b, t), _padded_ids(rng, b, t)
        for ids in (pred, gt):
            got, got_len = cer.strip_tokens(torch.from_numpy(ids).long())
            want, want_len = jcer.strip_tokens(ids)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got_len.numpy(),
                                          np.asarray(want_len))
        ed, ln = cer.cer_counts(torch.from_numpy(pred), torch.from_numpy(gt))
        jed, jln = jcer.cer_counts(pred, gt)
        assert (int(ed), int(ln)) == (int(jed), int(jln))
        a, b_ = (cer.strip_tokens(torch.from_numpy(x)) for x in (pred, gt))
        np.testing.assert_array_equal(
            cer.batched_levenshtein(a[0], a[1], b_[0], b_[1]).numpy(),
            np.asarray(jcer.batched_levenshtein(
                np.asarray(a[0]), np.asarray(a[1]), np.asarray(b_[0]),
                np.asarray(b_[1]))))
        logits = rng.normal(size=(b, t, VOCAB.size)).astype(np.float32)
        acc, jacc = cer.CERAccumulator(), jcer.CERAccumulator()
        acc.add_logits(torch.from_numpy(logits), torch.from_numpy(gt))
        jacc.add_logits(logits, gt)
        assert (acc.ed, acc.length, acc.value()) == \
            (jacc.ed, jacc.length, jacc.value())
    texts = [" ".join(VOCAB.decode(r) for r in _padded_ids(rng, 3, 6))
             for _ in range(12)]
    preds = texts[6:] + ["", "a b c"]
    assert cer.wer(preds, texts[:8]) == jcer.wer(preds, texts[:8])


def test_levenshtein_matches_a_plain_python_oracle():
    def lev(a, b):
        dp = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            prev, dp[0] = dp[0], i
            for j, cb in enumerate(b, 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
                prev = cur
        return dp[len(b)]

    rng = np.random.default_rng(0)
    pairs = [("".join(rng.choice(list("abcdef"), n)),
              "".join(rng.choice(list("abcdef"), m)))
             for n, m in rng.integers(0, 11, size=(32, 2))]

    def pad(ws):
        out = torch.zeros((len(ws), 10), dtype=torch.long)
        for i, w in enumerate(ws):
            out[i, :len(w)] = torch.tensor(VOCAB.encode(w), dtype=torch.long)
        return out, torch.tensor([len(w) for w in ws])

    (a, al), (b, bl) = pad([p[0] for p in pairs]), pad([p[1] for p in pairs])
    assert cer.batched_levenshtein(a, al, b, bl).tolist() == \
        [lev(x, y) for x, y in pairs]


def test_sheet_matches(tmp_path):
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(3, 32, 104, c)).astype(np.float32)
          for c in (1, 1, 5, 1)]
    texts = [["abc", "", "Hello"], ["x?y", "q", "zz"], ["t", "uv", "w"]]
    args = (xs[0], texts[0], xs[1], texts[1], xs[2], xs[3], texts[2],
            texts[0])
    got = sheets.write_sheet(str(tmp_path / "port"), "s", *args)
    want = jsheets.write_sheet(str(tmp_path / "jax"), "s", *args)
    assert got.endswith("port/s.png") and want.endswith("jax/s.png")
    for suffix in ("", ".npy"):
        a, b = tmp_path / "port" / f"s.png{suffix}", tmp_path / "jax" / \
            f"s.png{suffix}"
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_bytes() == b.read_bytes()
    assert (tmp_path / "port" / "s.png").exists() or \
        (tmp_path / "port" / "s.png.npy").exists()


def test_sheet_without_pil_is_saved_as_npy(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    sheets._save_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.load(tmp_path / "a.png.npy"), img)


# prefetch: the five cases of tests/test_prefetch.py


def test_prefetch_order_and_identity():
    src = [{"i": np.full((4,), i)} for i in range(20)]
    out = list(prefetch(iter(src), depth=3))
    assert len(out) == 20
    assert all(b is src[i] for i, b in enumerate(out))


def test_prefetch_exception_propagates():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_bounded_lookahead():
    pulled = []
    done = threading.Event()

    def gen():
        for i in range(100):
            pulled.append(i)
            yield i
        done.set()

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    time.sleep(0.3)
    assert not done.is_set()
    # queue of 2 + the one blocked in put + the one yielded
    assert len(pulled) <= 5, pulled
    it.close()


def test_prefetch_early_break_stops_producer():
    alive = threading.Event()
    alive.set()

    def gen():
        i = 0
        while alive.is_set():
            yield i
            i += 1
            time.sleep(0.01)

    it = prefetch(gen(), depth=2)
    for i, _ in enumerate(it):
        if i >= 3:
            break
    it.close()
    assert not any(t.name == "batch-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    alive.clear()


def test_prefetch_depth_zero_is_passthrough():
    assert list(prefetch(iter([1, 2, 3]), depth=0)) == [1, 2, 3]
