"""The port's batched beam search vs ``Recognizer.beam_search`` of the JAX
package, fp32 on the CPU, with converted weights (every flax leaf random,
tests/test_torch_support.py), in eval mode.

Limits: the token ids identical, the scores (sums of f32 log-probabilities
over 11 steps) within 1e-5 relative; at K = 1 the beam equals the port's own
greedy reading up to its first END (a finished beam only extends with END,
while greedy decoding runs on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models.recognizer.seq2seq import (
    Recognizer as JRecognizer,
)
from affganwriting_torch.core.config import VOCAB
from affganwriting_torch.models.recognizer.seq2seq import Recognizer
from test_torch_support import load_port, nchw, random_variables

torch.set_num_threads(2)   # tier-1 runs six xdist workers

B = 6


@pytest.fixture(scope="module")
def models():
    jrec = JRecognizer(VOCAB.size, 64, 16, 8, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    img = np.tanh(rng.normal(size=(B, 32, 104, 1))).astype(np.float32)
    labels = np.asarray([VOCAB.pad_label("beam", 8)] * B, np.int32)
    v = random_variables(jrec, img, labels, seed=9)
    rec = load_port(Recognizer(VOCAB.size, 64, 16, 8, 32, torch.float32), v)
    return jrec, v, rec, img, labels


def _until_end(row) -> list:
    row = list(row)
    return row[: row.index(VOCAB.end) + 1] if VOCAB.end in row else row


@pytest.mark.parametrize("k", [1, 3])
def test_beam_search_matches(models, k):
    jrec, v, rec, img, labels = models
    want_ids, want_scores = jax.jit(lambda im: jrec.apply(
        v, im, beam_size=k, method=jrec.beam_search))(img)
    with torch.inference_mode():
        ids, scores = rec.beam_search(nchw(img), beam_size=k)
    assert ids.shape == (B, 7) and scores.shape == (B,)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5, atol=0)
    assert int(ids.min()) >= 0 and int(ids.max()) < VOCAB.size
    if k == 1:
        with torch.inference_mode():
            logits, _ = rec(nchw(img), torch.from_numpy(labels).long())
        greedy = logits.argmax(-1).numpy()
        for a, b in zip(ids.numpy(), greedy):
            assert _until_end(a) == _until_end(b)


def test_stable_top_k_takes_the_lower_index_on_ties():
    """The tie rule of ``lax.top_k`` that the beam's sort keeps: with every
    logit equal, the first step expands beam 0 into tokens 0, 1 (END) and
    2; the END beam then extends only with END at cost 0, so it ends best,
    at one step's log-probability.  Another order among the ties would miss
    END and end 5 steps' worth lower."""
    rec = Recognizer(VOCAB.size, 8, 4, 6, 32, torch.float32).eval()
    with torch.no_grad():
        for p in rec.dec.out.parameters():
            p.zero_()
        ids, scores = rec.beam_search(torch.zeros(2, 1, 32, 104),
                                      beam_size=3)
    assert ids.tolist() == [[VOCAB.end] * 5] * 2
    assert torch.allclose(scores, torch.full((2,), -np.log(VOCAB.size)))
