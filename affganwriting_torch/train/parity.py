"""The one-step parity check of the train step, its limits, and the f64
reference that the gradient checks rest on.

``tests/test_torch_train_step.py`` holds the port's merged step against the
JAX package's with it on the CPU, and ``chip_smoke.py`` (phase 6a) holds the
port on the card against the port on the CPU, so both read the same
configuration and the same limits from here.  ``in_f64`` runs the port's
modules in f64: the tests' exact reference and the on-card smoke's
(phases 12a and 13a/b).

The configuration has the native 64x216 geometry (D and C at 6 layers end
at 2x7) at small widths, fp32, SGD: a delta is the learning rate times the
gradient (Adam would turn float noise in a near-zero gradient into a
full-rate sign flip).  G steps at 1.0, so its delta is its gradient; D, C
and R at 1e-3, since at 1.0 their updates blow up before G's phase (C's
logits grow by orders of magnitude and G's loss is then C's alone).
``w_rec`` is 0: R's greedy feedback on random fakes has top-2 margins of
the order of the fakes' float error, so its ids flip even between the
port's f32 and f64 steps and move ``l_rec`` discretely.  R's gradient into
G is held by its own tests (``tests/test_torch_train_modules.py``,
``tests/test_torch_train_step.py``).

The limits sit at about twice the measured disagreement, which is f32's
and not the port's: G's update is ill-conditioned at random weights (one
ulp on the style stack moves the port's own G delta by 2.7e-2, relative
L2), and the port's and the JAX package's f32 steps lie 3.8e-2 and 4.5e-2
from the port's f64 step.  ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_train_step.py`` prints these readings.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import torch

STEP_CONFIG = dict(compute_dtype="float32", img_height=64, img_width=216,
                   max_chars=6, style_dim=64, adain_param_dim=512,
                   text_embed_dim=16, rec_hidden=64, rec_embed=16,
                   dis_layers=6, num_writers=8, optimizer="sgd", lr_gen=1.0,
                   lr_dis=1e-3, lr_cla=1e-3, lr_rec=1e-3, w_rec=0.0)
STEP_BATCH = 4

# relative to max(1, |reference|): every metric, and the new running
# statistics; absolute: the fakes (tanh images)
LOSS_TOL = 2e-3
STATS_TOL = 2e-3
XG_TOL = 5e-3
# player: (relative L2 error over all its leaves, over each leaf); a leaf
# is measured against the larger of its own norm and LEAF_FLOOR times the
# player's largest leaf norm
DELTA_TOL = {"gen": (0.08, 0.09), "dis": (5e-3, 1e-2), "cla": (1e-4, 5e-4),
             "rec": (2e-2, 2e-2)}
LEAF_FLOOR = 1e-3


def is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def delta_errors(got: Mapping[str, torch.Tensor],
                 want: Mapping[str, torch.Tensor],
                 before: Mapping[str, torch.Tensor]):
    """One player's update ``got - before`` against ``want - before``, leaf
    by leaf over its parameters: (relative L2 error over all leaves, {leaf:
    relative error}), each leaf against ``LEAF_FLOOR`` of the largest."""
    d_got = {k: got[k].double() - before[k].double() for k in before
             if not is_stat(k)}
    d_want = {k: want[k].double() - before[k].double() for k in d_got}
    norms = {k: float(v.norm()) for k, v in d_want.items()}
    floor = LEAF_FLOOR * max(norms.values())
    sq, per_leaf = 0.0, {}
    for k, w in d_want.items():
        err = float((d_got[k] - w).norm())
        per_leaf[k] = err / max(norms[k], floor, 1e-30)
        sq += err ** 2
    l2 = (sq / max(sum(n ** 2 for n in norms.values()), 1e-60)) ** 0.5
    return l2, per_leaf


def delta_ok(name: str, l2: float, per_leaf: Mapping[str, float]) -> bool:
    l2_tol, leaf_tol = DELTA_TOL[name]
    return l2 <= l2_tol and max(per_leaf.values()) <= leaf_tol


@contextlib.contextmanager
def in_f64(*modules):
    """The port's ``modules`` compute in f64 inside the block: parameters,
    compute dtypes, and every ``.float()`` they take; the exact reference
    that the f32 gradient checks of the tests and of the on-card smoke
    rest on."""
    for module in modules:
        module.double()
        for m in module.modules():
            for attr in ("compute_dtype", "dtype"):
                if getattr(m, attr, None) is torch.float32:
                    setattr(m, attr, torch.float64)
    as_f32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = as_f32
        torch.set_default_dtype(torch.float32)
