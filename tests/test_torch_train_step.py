"""The port's four-player train step vs the JAX package's, fp32 on the CPU.

One merged step (``make_phased_train_step(cfg, merge_dg=True)``) of each
package from the same random flax leaves (tests/test_torch_support.py),
converted by ``utils/from_flax.word_gan_from_flax``, on the same batch of
4 words at 64x216 (batch 2 makes flax's fast variance ill-conditioned, see
tests/test_torch_train_modules.py).  R's dropout is 0 on both sides (the
JAX models are patched from this file only).  The JAX step is jitted and
computed once per module: its compile is most of this file's time.

The configuration and the limits are ``affganwriting_torch/train/parity``'s,
which chip_smoke.py holds the card to as well; that module says why G
steps at 1.0 and D, C and R at 1e-3, and why ``w_rec`` is 0 there.  R's
term of G's loss is held in two parts instead: its gradient with respect
to the fakes against the JAX package
(tests/test_torch_train_modules.py), and here, that the G phase carries
exactly that gradient back into G
(``test_g_phase_sends_r_term_gradient_to_g``).

Limits.  R's greedy ids as ``test_greedy_ids_agree`` says.  Every metric
within ``LOSS_TOL`` of max(1, |reference|), the fakes within ``XG_TOL``,
the running statistics within ``STATS_TOL``, each player's delta within
``DELTA_TOL`` (relative L2 over all its leaves, and over each leaf).  They
sit at about twice what f32 itself gives: against the port's f64 step, the
port's f32 step and the JAX package's are 1.4e-3 and 2.4e-3 off on the
fakes, and 3.8e-2 and 4.5e-2 on G's delta (relative L2); scaling the
style stack by one ulp moves the port's own G delta by 2.7e-2.  Run this
file as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_train_step.py``) to print
those readings.  A leaf stepped 1.1 times fails the limits
(``test_delta_limits_reject_a_leaf_stepped_1_1_times``), and so does a G
computed in bf16.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from affganwriting_torch.models.blocks import frozen_stats
from affganwriting_torch.train import losses
from affganwriting_torch.train.parity import (
    DELTA_TOL,
    LEAF_FLOOR,
    LOSS_TOL,
    STATS_TOL,
    STEP_BATCH,
    STEP_CONFIG,
    XG_TOL,
    delta_errors,
    delta_ok,
    is_stat,
)
from affganwriting_torch.train.state import (
    PLAYERS,
    init_state,
    make_optimizers,
    set_rec_lr,
)
from affganwriting_torch.train.step import (
    generate_pair,
    make_phased_train_step,
    to_device_batch,
)
from test_torch_support import (
    TRAIN_SMALL,
    close,
    jax_merged_step,
    port_in_f64,
    port_merged_step,
    small_jax_config,
    small_torch_config,
    word_batch,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

B = STEP_BATCH
BATCH_SEED = 11


@pytest.fixture(scope="module")
def runs():
    """One merged step of each package from the same weights and batch."""
    jcfg = small_jax_config(**STEP_CONFIG)
    tcfg = small_torch_config(**STEP_CONFIG)
    batch = word_batch(tcfg, B, BATCH_SEED)
    want = jax_merged_step(jcfg, tcfg, batch)
    return want, port_merged_step(tcfg, want["before"], batch), batch


def test_greedy_ids_agree(runs):
    """R free-runs on argmax feedback, so a flipped id moves l_rec
    discretely: the ids are checked before the losses.  On the real words
    every id must agree.  On the fakes, which differ by up to ~4e-3 between
    the packages, an id can flip only where the reference's top-2 margin is
    below twice the largest logit difference at that step: every other id
    must agree, and at least half of them must be such."""
    want, got, _ = runs
    np.testing.assert_array_equal(got["extras"]["rec_logits_tr"].argmax(-1),
                                  want["extras"]["rec_logits_tr"].argmax(-1))
    for k in ("logits_xt", "logits_swap"):
        a, b = got["extras"][k], want["extras"][k]
        top2 = np.sort(b, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(a - b).max(-1)
        assert clear.mean() >= 0.5, (k, clear.mean())
        np.testing.assert_array_equal(a.argmax(-1)[clear],
                                      b.argmax(-1)[clear], k)


def test_metrics_and_fakes_match(runs):
    want, got, _ = runs
    assert got["step"] == 1
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * max(1.0, abs(w)), \
            (k, got["metrics"][k], w)
    err = np.abs(got["extras"]["xg"] - want["extras"]["xg"]).max()
    assert err <= XG_TOL, err


@pytest.mark.parametrize("name", PLAYERS)
def test_parameter_deltas_match(runs, name):
    """Each player's update, leaf by leaf, as the learning rate times its
    gradient."""
    want, got, _ = runs
    before = want["before"][name]
    assert set(got["after"][name]) == set(want["after"][name])
    l2, per_leaf = delta_errors(got["after"][name], want["after"][name],
                                before)
    worst = max(per_leaf, key=per_leaf.get)
    assert delta_ok(name, l2, per_leaf), (name, l2, worst, per_leaf[worst])
    moved = [k for k in per_leaf
             if bool((want["after"][name][k] != before[k]).any())]
    assert len(moved) > 0.9 * len(per_leaf), \
        f"{name}: {len(moved)}/{len(per_leaf)} moved"


@pytest.mark.parametrize("name", PLAYERS)
def test_delta_limits_reject_a_leaf_stepped_1_1_times(runs, name):
    """The port's own update with any one leaf (of those the floor does not
    cover) stepped 1.1 times fails the limits."""
    want, got, _ = runs
    before = want["before"][name]
    d_got, d_want = ({k: sd[name][k].double() - before[k].double()
                      for k in before if not is_stat(k)}
                     for sd in (got["after"], want["after"]))
    norms = {k: float(v.norm()) for k, v in d_want.items()}
    floor = LEAF_FLOOR * max(norms.values())
    leaf_tol = DELTA_TOL[name][1]
    passed = [k for k in d_want if norms[k] >= floor and float(
        (1.1 * d_got[k] - d_want[k]).norm()) <= leaf_tol * norms[k]]
    assert not passed, passed[:5]


@pytest.mark.parametrize("name", ["gen", "rec"])
def test_running_stats_match(runs, name):
    want, got, _ = runs
    keys = [k for k in want["after"][name] if is_stat(k)]
    assert keys
    for k in keys:
        assert not torch.equal(want["after"][name][k],
                               want["before"][name][k]), k
        close(got["after"][name][k], want["after"][name][k], STATS_TOL, k)


def test_g_phase_sends_r_term_gradient_to_g():
    """With R's term alone in G's loss (``w_rec`` 1, the other weights 0)
    and G alone stepping (SGD, G at 1.0, the others at 0), G's update is
    minus the gradient of R's term with respect to both fakes (held against
    the JAX package in tests/test_torch_train_modules.py), carried back
    through G's pair forward: no cut and no other path between the fakes
    and R's loss.  Small 32x104 config."""
    cfg = small_torch_config(**TRAIN_SMALL).replace(
        optimizer="sgd", lr_gen=1.0, lr_dis=0.0, lr_cla=0.0, lr_rec=0.0,
        w_dis=0.0, w_cla=0.0, w_l1=0.0, w_rec=1.0)
    batch = word_batch(cfg, B, BATCH_SEED)
    state = init_state(cfg, device="cpu", seed=1, rec_dropout=0.0)
    gen, rec = state.gen.model.train(), state.rec.model.train()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    b = to_device_batch(batch, torch.device("cpu"))
    keys = ("label_xt", "label_xt_swap")
    with frozen_stats(gen):
        pair = generate_pair(gen, b["style"], *(b[k] for k in keys))
    fakes = [x.detach().requires_grad_() for x in pair]
    with frozen_stats(rec):
        l_rec = 0.5 * sum(
            losses.rec_loss(rec(x, b[k])[0], b[k], cfg.label_smoothing)
            for x, k in zip(fakes, keys))
    cotangents = torch.autograd.grad(l_rec, fakes)
    names = [n for n, _ in gen.named_parameters()]
    grads = torch.autograd.grad(pair, list(gen.parameters()), cotangents,
                                allow_unused=True)
    want = {n: torch.zeros_like(before[n]) if g is None else -g
            for n, g in zip(names, grads)}

    state, metrics, _ = make_phased_train_step(cfg, True, device="cpu")(
        state, batch, torch.Generator().manual_seed(0))
    close(float(metrics["l_rec"]), float(l_rec.detach()), 1e-6, "l_rec")
    after = state.gen.model.state_dict()
    got = {n: after[n] - before[n] for n in names}
    sq = sum(float((got[n] - want[n]).double().norm()) ** 2 for n in names)
    ref = sum(float(want[n].double().norm()) ** 2 for n in names)
    assert ref > 0
    assert (sq / ref) ** 0.5 <= 1e-5, (sq / ref) ** 0.5
    moved = sum(bool(want[n].abs().max() > 0) for n in names)
    assert moved > 0.9 * len(names), f"{moved}/{len(names)} moved"


def test_merged_step_equals_four_phase_step():
    """The merged D+G phase and the 4-phase form give one update, here with
    R's term in G's loss (``w_rec`` 1) and every rate at 1.0, on the small
    32x104 config (D and C at 5 layers)."""
    cfg = small_torch_config(**TRAIN_SMALL).replace(
        optimizer="sgd", lr_gen=1.0, lr_dis=1.0, lr_cla=1.0, lr_rec=1.0)
    batch = word_batch(cfg, B, BATCH_SEED)
    out = {}
    for merge in (True, False):
        state = init_state(cfg, device="cpu", seed=1, rec_dropout=0.0)
        before = {n: {k: v.clone() for k, v in
                      getattr(state, n).model.state_dict().items()}
                  for n in PLAYERS}
        phases = []
        state, metrics, _ = make_phased_train_step(cfg, merge, device="cpu")(
            state, batch, torch.Generator().manual_seed(0), phases.append)
        assert phases == (["rec", "cla", "dis_gen"] if merge
                          else ["rec", "cla", "dis", "gen"])
        after = {n: getattr(state, n).model.state_dict() for n in PLAYERS}
        out[merge] = (metrics, {n: {k: after[n][k] - before[n][k]
                                    for k in before[n] if not is_stat(k)}
                                for n in PLAYERS})
    for k, v in out[True][0].items():
        close(float(out[False][0][k]), float(v), 1e-4, k)
    for name in PLAYERS:
        for k, v in out[True][1][name].items():
            close(out[False][1][name][k], v, 1e-4, f"{name}.{k}")


def test_adam_matches_optax():
    """torch.optim.Adam with torch's defaults is optax.adam: three steps on
    fixed gradients, at each player's learning rate."""
    cfg = small_torch_config(**TRAIN_SMALL)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(cfg.lr_gen)
    p, s = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    module = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(p0))
    topt = make_optimizers(cfg, {n: module for n in PLAYERS})["gen"]
    assert isinstance(topt, torch.optim.Adam)
    for g in grads:
        u, s = opt.update(jnp.asarray(g), s, p)
        p = p + u
        module.weight.grad = torch.from_numpy(g)
        topt.step()
        close(module.weight, p, 1e-6)


def test_rec_lr_is_settable_between_steps_and_frozen_r_has_no_optimizer():
    cfg = small_torch_config(**STEP_CONFIG)
    state = init_state(cfg, device="cpu", rec_dropout=0.0)
    set_rec_lr(state, 0.25)
    assert [g["lr"] for g in state.rec.opt.param_groups] == [0.25]
    frozen = init_state(cfg.replace(rec_frozen=True), device="cpu")
    assert frozen.rec.opt is None
    with pytest.raises(ValueError, match="frozen"):
        set_rec_lr(frozen, 0.1)


def test_frozen_r_keeps_its_params_and_moves_its_stats():
    cfg = small_torch_config(**TRAIN_SMALL).replace(optimizer="sgd",
                                                    rec_frozen=True)
    state = init_state(cfg, device="cpu", rec_dropout=0.0)
    before = {k: v.clone() for k, v in state.rec.model.state_dict().items()}
    state, metrics, _ = make_phased_train_step(cfg, True, device="cpu")(
        state, word_batch(cfg, B, BATCH_SEED),
        torch.Generator().manual_seed(0))
    after = state.rec.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if not is_stat(k))
    assert not torch.equal(after["enc.vgg.bn0.running_mean"],
                           before["enc.vgg.bn0.running_mean"])
    assert all(p.grad is None for p in state.rec.model.parameters())
    assert np.isfinite(float(metrics["l_rec_tr"]))


def _port_step_f64(tcfg, weights, batch):
    """The port's step computed in f64."""
    state = init_state(tcfg, device="cpu", weights=weights, rec_dropout=0.0)
    with port_in_f64(*(getattr(state, n).model for n in PLAYERS)):
        state, _, extras = make_phased_train_step(
            tcfg, merge_dg=True, device="cpu")(
            state, batch, torch.Generator().manual_seed(0))
    return {"after": {n: getattr(state, n).model.state_dict()
                      for n in PLAYERS},
            "extras": {k: v.numpy() for k, v in extras.items()}}


def conditioning_readings():
    """The readings the limits rest on, on the test's configuration,
    weights and batch: the port's f32 step and the JAX package's against
    the port's f64 step, the port's step with the style stack scaled by one
    ulp against its own, and the port computing in bf16 against the JAX
    package."""
    jcfg = small_jax_config(**STEP_CONFIG)
    tcfg = small_torch_config(**STEP_CONFIG)
    batch = word_batch(tcfg, B, BATCH_SEED)
    ref = jax_merged_step(jcfg, tcfg, batch)
    f32 = port_merged_step(tcfg, ref["before"], batch)
    f64 = _port_step_f64(tcfg, ref["before"], batch)
    ulp = port_merged_step(tcfg, ref["before"], dict(
        batch, style_imgs=batch["style_imgs"] * np.float32(1 + 2 ** -23)))
    bf16 = port_merged_step(tcfg.replace(compute_dtype="bfloat16"),
                            ref["before"], batch)
    for what, a, b in (("port f32 vs port f64", f32, f64),
                       ("JAX f32 vs port f64", ref, f64),
                       ("port f32 vs JAX f32", f32, ref),
                       ("port f32, style x (1 + ulp), vs port f32", ulp,
                        f32),
                       ("port bf16 vs JAX f32", bf16, ref)):
        xg = np.abs(a["extras"]["xg"] - b["extras"]["xg"]).max()
        ids = [np.mean(a["extras"][k].argmax(-1) == b["extras"][k].argmax(-1))
               for k in ("logits_xt", "logits_swap")]
        parts = [f"xg max|err| {xg:.3g}",
                 "R's ids on the fakes agree {:.3f}, {:.3f}".format(*ids)]
        for n in PLAYERS:
            l2, per_leaf = delta_errors(a["after"][n], b["after"][n],
                                        ref["before"][n])
            parts.append(f"{n} delta L2 {l2:.3g} "
                         f"leaf {max(per_leaf.values()):.3g}")
        print(f"{what}: " + ", ".join(parts), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    conditioning_readings()
