"""The port's eval step vs the JAX package's ``train/eval_step.py``, fp32
on the CPU: both words generated in eval mode from the same random flax
leaves (tests/test_torch_support.py), scored by D, C and R.

The JAX step runs with jit disabled (eager), which skips its CPU compile and
computes the same values.  Tolerance 2e-3 on images and losses, as
tests/test_torch_pipeline.py holds the eval-mode models.  R reads the
fakes, which differ between the packages by up to 2e-3, and its logits are
not returned, so a greedy id may flip at a near tie: at least 90% must
agree.
"""

import jax
import numpy as np
import torch

from affganwriting_tpu.train.eval_step import make_eval_step as jax_eval
from affganwriting_torch.train.eval_step import make_eval_step
from affganwriting_torch.train.state import init_state
from affganwriting_torch.utils.from_flax import word_gan_from_flax
from test_torch_support import (
    TRAIN_SMALL,
    close,
    jax_word_gan_state,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
    word_batch,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_eval_step_matches_jax():
    jcfg = small_jax_config(**TRAIN_SMALL)
    tcfg = small_torch_config(**TRAIN_SMALL)
    batch = word_batch(tcfg, 4, seed=5)
    del batch["label_ch0"]
    state, _ = jax_word_gan_state(jcfg, batch, rec_dropout=0.5)
    with jax.disable_jit():
        want_m, want_p, want_i = jax_eval(jcfg)(state, batch)
    port = init_state(tcfg, device="cpu", weights=word_gan_from_flax(
        to_numpy_tree(state), tcfg))
    metrics, preds, images = make_eval_step(tcfg, device="cpu")(port, batch)

    assert set(metrics) == set(want_m) and set(preds) == set(want_p)
    for k in ("xg", "xg_swap"):
        assert images[k].shape == (4, 32, 104, 1)
        close(images[k], want_i[k], 2e-3, k)
    for k, v in want_m.items():
        close(float(metrics[k]), float(v), 2e-3, k)
    for k in ("pred_xt", "pred_swap"):
        same = preds[k].numpy() == np.asarray(want_p[k])
        assert same.mean() >= 0.9, (k, same.mean())
    assert not any(getattr(port, n).model.training
                   for n in ("gen", "dis", "cla", "rec"))
