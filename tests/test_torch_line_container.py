"""The port's ``HWWithStyle`` (``models/line/container.py``) vs the JAX
package's, f32 on the CPU, eval mode, with ``char_style_dim`` 0 and 4, at
small widths (12 classes, style 16, generator 32, 64 x 64 lines, spaced
length 12); every flax leaf random, the ``NoiseInjection`` weights 0 in
both trees (flax draws the noise from ``make_rng("noise")``; the
generator's own comparison is in ``test_torch_line_models.py``).

- ``extract_style`` (``a_batch_size`` 1 and 2) and ``recognize``: 1e-4
  (atol and rtol), the limit of the parts;
- ``space``: counts within 1e-4 and spaced lines and padded fractions
  equal (the spacing noise, std 1e-8, moves no count that is not at a
  rounding tie, so the two packages' draws give the same lines);
- ``__call__`` on the JAX package's spaced line, and ``generate``: 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from affganwriting_tpu.models.line.container import HWWithStyle as JHW
from affganwriting_torch.models.line.container import HWWithStyle
from test_torch_support import (
    LINE_CLASSES as K,
    close,
    japply,
    line_variables,
    load_line,
    nchw,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", params=[0, 4])
def hw_pair(request):
    """The container at small widths (12 classes, style 16, generator 32,
    lines of 64 x 64, spaced length 12) with ``char_style_dim``
    ``request.param``; the flax tree's noise weights 0."""
    csd = request.param
    b, t = 4, 5
    img = RNG.normal(size=(b, 64, 64, 1)).astype(np.float32)
    label = RNG.integers(1, K, (b, t)).astype(np.int32)
    lengths = np.asarray([5, 3, 4, 2], np.int32)
    kw = dict(n_class=K, style_dim=16, gen_dim=32, max_gen_length=12,
              char_style_dim=csd)
    jm = JHW(**kw)
    v = line_variables(jm, img, label, lengths, method=jm.init_all,
                       zero_noise=True)
    tm = load_line(HWWithStyle(**kw), v)
    return jm, v, tm, img, label, lengths


@pytest.mark.parametrize("a_batch_size", [1, 2])
def test_hw_with_style_extract_and_recognize_match_jax(hw_pair,
                                                       a_batch_size):
    jm, v, tm, img, _, _ = hw_pair
    want_style, want_pred = japply(jm, v, img, method=jm.extract_style,
                                   a_batch_size=a_batch_size)
    style, pred = tm.extract_style(nchw(img), a_batch_size)
    close(pred, want_pred, 1e-4, "HWR log-probs")
    close(style, want_style, 1e-4, "style")
    if a_batch_size == 2:       # one style per author, repeated
        torch.testing.assert_close(style[0], style[1], rtol=0, atol=0)
    close(tm.recognize(nchw(img)), japply(jm, v, img, method=jm.recognize),
          1e-4, "recognize")


def test_hw_with_style_space_and_generate_match_jax(hw_pair):
    jm, v, tm, img, label, lengths = hw_pair
    style, _ = japply(jm, v, img, method=jm.extract_style)
    style_t = torch.from_numpy(np.asarray(style))
    rngs = {"spacing": jax.random.key(1), "noise": jax.random.key(2)}
    spaced_j, counts_j, padded_j = japply(jm, v, label, lengths, style,
                                          method=jm.space, rngs=rngs)
    spaced, counts, padded = tm.space(
        torch.from_numpy(label), torch.from_numpy(lengths), style_t,
        generator=torch.Generator().manual_seed(1))
    close(counts, counts_j, 1e-4, "counts")
    np.testing.assert_array_equal(spaced.numpy(), np.asarray(spaced_j))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(padded_j))
    # the same spaced line into the generator, noise weights 0 on both
    want, _, _ = japply(jm, v, label, lengths, style, spaced_j, rngs=rngs)
    got, _, _ = tm(torch.from_numpy(label), torch.from_numpy(lengths),
                   style_t, spaced)
    assert got.shape == (4, 1, 64, 48)
    close(got.permute(0, 2, 3, 1), want, 1e-4, "line")
    want = japply(jm, v, label, lengths, style, rngs=rngs,
                  method=jm.generate)
    got = tm.generate(torch.from_numpy(label), torch.from_numpy(lengths),
                      style_t, generator=torch.Generator().manual_seed(4))
    close(got.permute(0, 2, 3, 1), want, 1e-4, "generate")
