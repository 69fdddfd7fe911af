"""Readings behind ``tests/test_torch_trainer.py``'s ``EPOCH_CONFIG``: one
trainer epoch of the JAX package, of the port and of the port in f64, from
the same converted weights on the same batch stream.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_epoch_readings.py \
        [--steps 2] [--lr-gen 0.0] [--lr-rec 1e-5]

prints, per player, how far the JAX package's and the port's f32 updates
over the epoch lie from the port's f64 one (relative L2 over the
parameters), then per step the losses of the three runs, how far the fakes
lie from the f64 run's, and how many of R's ids on the fakes lie within
twice the logit difference of a tie.  The synthetic words seed from
``hash(word)``, so the batches, and the readings, change from process to
process.  About three minutes on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib

import jax
import numpy as np
import pytest
import torch

import affganwriting_tpu.train.step as jstep
import affganwriting_torch.utils.logging as logging
from affganwriting_tpu.data.words import WordStyleDataset as JDataset
from affganwriting_tpu.train.loop import WordGanTrainer as JTrainer
from affganwriting_torch.train import parity
from affganwriting_torch.train.loop import WordGanTrainer
from affganwriting_torch.train.state import PLAYERS, init_state
from affganwriting_torch.utils.from_flax import word_gan_from_flax
from test_torch_support import (
    jax_word_gan_state,
    port_in_f64,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)
from test_torch_trainer import _datasets, _Log, _recording


def delta_error(got, want, before) -> float:
    """|got - want| / |want - before| over the parameters (relative L2)."""
    keys = [k for k in before if not parity.is_stat(k)]
    err = sum(float((got[k].double() - want[k].double()).norm()) ** 2
              for k in keys)
    ref = sum(float((want[k].double() - before[k].double()).norm()) ** 2
              for k in keys)
    return (err / max(ref, 1e-60)) ** 0.5


def ties(a, w) -> int:
    top2 = np.sort(w, -1)[..., -2:]
    return int((top2[..., 1] - top2[..., 0] <= 2 * np.abs(a - w).max(-1))
               .sum())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--lr-gen", type=float, default=0.0)
    p.add_argument("--lr-rec", type=float, default=1e-5)
    args = p.parse_args(argv)
    logging.summary_writer = lambda logdir: None
    over = dict(parity.STEP_CONFIG, lr_gen=args.lr_gen, lr_rec=args.lr_rec)
    jcfg = small_jax_config(**over).replace(batch_size=parity.STEP_BATCH)
    tcfg = small_torch_config(**over).replace(batch_size=parity.STEP_BATCH)
    writers = parity.STEP_BATCH * args.steps
    jtrain, _ = _datasets(jcfg, writers, dataset=JDataset)
    train, _ = _datasets(tcfg, writers)
    jstate, models = jax_word_gan_state(jcfg, next(train.batches(epoch=0)))
    weights = word_gan_from_flax(to_numpy_tree(jstate), tcfg)

    ref = JTrainer.__new__(JTrainer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_models", lambda cfg: models)
        ref.train_step = _recording(
            jstep.make_phased_train_step(jcfg, merge_dg=True), jseen := [])
    ref.config, ref.train_data, ref.mesh = jcfg, jtrain, None
    ref.state, ref.rng, ref.logger = jstate, jax.random.key(0), _Log()
    ref.save_latest_every_steps = 10**9
    ref.train_epoch(0)

    runs = {"jax": (word_gan_from_flax(to_numpy_tree(ref.state), tcfg),
                    jseen)}
    for name, f64 in (("f32", False), ("f64", True)):
        trainer = WordGanTrainer(tcfg, train, logdir=f"build/readings_{name}",
                                 restart_rss_gb=0, device="cpu")
        trainer.state = init_state(tcfg, "cpu", weights=weights,
                                   rec_dropout=0.0)
        trainer.train_step = _recording(trainer.train_step, steps := [])
        mods = [getattr(trainer.state, n).model for n in PLAYERS]
        with port_in_f64(*mods) if f64 else contextlib.nullcontext():
            trainer.train_epoch(0)
        runs[name] = ({n: getattr(trainer.state, n).model.state_dict()
                       for n in PLAYERS}, steps)

    exact = runs["f64"][0]
    print(f"lr_gen {args.lr_gen}, lr_rec {args.lr_rec}, {args.steps} steps")
    for n in PLAYERS:
        print(f"{n}: update vs f64, relative L2: jax "
              f"{delta_error(runs['jax'][0][n], exact[n], weights[n]):.3g}, "
              f"port f32 "
              f"{delta_error(runs['f32'][0][n], exact[n], weights[n]):.3g}")

    def host(t):
        return np.asarray(t.double() if isinstance(t, torch.Tensor) else t,
                          np.float64)

    for i in range(args.steps):
        (m64, e64, _), n_ids = runs["f64"][1][i], 0
        for name in ("f32", "jax"):
            m, ext, _ = runs[name][1][i]
            xg = np.abs(host(ext["xg"]) - host(e64["xg"])).max()
            tied = 0
            for lk in ("logits_xt", "logits_swap"):
                a, w = host(ext[lk]), host(e64[lk])
                tied += ties(a, w)
                n_ids = a.shape[0] * a.shape[1] * 2
            losses = ", ".join(f"{k} {float(v):.7g}" for k, v in m.items())
            print(f"step {i} {name}: fakes {xg:.3g} max abs from f64, "
                  f"{tied} of {n_ids} ids on them near a tie; {losses}")
        _, ext, _ = runs["f32"][1][i]
        _, jext, _ = runs["jax"][1][i]
        tied = sum(ties(host(ext[lk]), host(jext[lk]))
                   for lk in ("logits_xt", "logits_swap"))
        print(f"step {i} f32 vs jax: {tied} of {n_ids} ids on the fakes "
              "near a tie")
        print(f"step {i} f64: " + ", ".join(
            f"{k} {float(v):.7g}" for k, v in m64.items()))


if __name__ == "__main__":
    main()
