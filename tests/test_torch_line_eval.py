"""The port's ``eval/line_eval.evaluate_lines`` against the JAX package's,
f32 on the CPU, from one line-GAN state carried over
(``test_torch_support.line_trainer_pair``: 12 classes, style 16,
generator 32, lines of 64 x 128), over two batches of two authors with
two lines each.

Both packages' generator noise is times 0 and flax's ``Dropout`` the
identity (``deterministic_line_gan``); the models run in eval mode, so
the only draws left are the spacing noise (std 1e-8), which moves no
count that is not at a rounding tie.  Limits: ``rec_cer``, ``wer``,
``gen_cer`` and the retrieval rates equal (they count greedy CTC decodes
of the frozen recognizer); ``recon_l1`` within 1e-5.
"""

import jax
import numpy as np
import torch

from test_torch_support import (
    deterministic_line_gan,
    line_batch,
    line_trainer_pair,
)
from affganwriting_tpu.data.lines import LineCharset as JCharset
from affganwriting_tpu.eval.line_eval import evaluate_lines as jeval
from affganwriting_torch.data.lines import LineCharset as TCharset
from affganwriting_torch.eval.line_eval import evaluate_lines as teval

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_evaluate_lines_matches_jax():
    batches = [dict(line_batch(seed=s), authors=["w0", "w0", f"w{s}",
                                                  f"w{s}"])
               for s in (1, 2)]
    with deterministic_line_gan():
        jt, js, tt, ts = line_trainer_pair(0)
        want = jeval(jt, js, iter(batches), JCharset(),
                     key=jax.random.key(0))
        got = teval(tt, ts, iter(batches), TCharset(), seed=0)
    assert set(got) == set(want) == {"rec_cer", "gen_cer", "recon_l1",
                                     "wer", "top1", "top5"}
    for k in ("rec_cer", "gen_cer", "wer", "top1", "top5"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert abs(got["recon_l1"] - want["recon_l1"]) <= 1e-5
    assert np.isfinite(got["recon_l1"]) and got["recon_l1"] > 0
    # max_batches stops after the first batch, as in the JAX function
    with deterministic_line_gan():
        one = teval(tt, ts, iter(batches), TCharset(), max_batches=1)
    assert one != got
