"""Pretrain the perceptual autoencoder (the reference's AutoTrainer run):
``python -m affganwriting_torch.cli.train_auto --iterations 6000``.

The port of ``affganwriting_tpu/cli/train_auto.py``: line_generation
pretrains the '2tight' Autoencoder with L1 reconstruction plus CTC through
the E_HWR head on its bottleneck (trainer/auto_trainer.py +
configs/cf_IAM_auto_2tight_newCTC.json: lr 2e-4 betas (0.5, 0.999), batch
8, loss_weights auto=1 recog=1, model {type: 2tight, hwr: 80}); the GAN
trainer then freezes the trained encoder as its perceptual-loss feature
space (hw_with_style_trainer.py:139-149, 735-758).  This CLI is that stage
(``train/auto_trainer.py``) over the synthetic line batches
(``data/lines.LineDataset``), with the JAX CLI's flags and ``--device``
(default the card; ``cpu`` runs on the CPU).

``<logdir>/ae_final`` is refreshed every ``--save-every`` iterations and
at the end, swap-written (``core/checkpoint.save_swap``): one
``torch.save`` file holding ``{"params": the AE's state dict}``, which
``cli/train_line --pretrained-ae`` reads.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Train; returns (trainer, final state, the ``ae_final`` path)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iterations", type=int, default=60_000,
                   help="reference recipe trains 60k (trainer.iterations)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--variant", default="2tight")
    p.add_argument("--ctc-weight", type=float, default=1.0,
                   help="the 'newCTC' E_HWR regularizer weight "
                        "(loss_weights.recog); 0 trains pure-L1")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--logdir", default="runs/auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=2000,
                   help="refresh ae_final every N iterations; 0 = end only")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import os

    from affganwriting_torch.core.checkpoint import save_swap
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.train.auto_trainer import AutoTrainer
    from affganwriting_torch.utils.logging import MetricsLogger

    charset = LineCharset()
    trainer = AutoTrainer(lr=args.lr, seed=args.seed,
                          ctc_weight=args.ctc_weight,
                          n_class=charset.n_class, variant=args.variant,
                          device=args.device)
    ds = LineDataset(charset, a_batch_size=1, width=args.width,
                     seed=args.seed)
    logger = MetricsLogger(args.logdir)
    state = trainer.init_state()
    path = os.path.abspath(os.path.join(args.logdir, "ae_final"))

    def save():
        save_swap(path, {"params": {k: v.detach().cpu() for k, v in
                                    state.ae.state_dict().items()}})

    def stream():
        epoch = 0
        while True:
            yield from ds.batches(args.batch_size, epoch=epoch)
            epoch += 1

    it = 0
    for batch in stream():
        if it >= args.iterations:
            break
        state, loss, l1 = trainer.step(state, batch["image"], batch["label"],
                                       batch["label_lengths"])
        if it % args.log_every == 0:
            logger.log(it, {"ae_loss": float(loss), "ae_l1": float(l1)},
                       group="auto")
        it += 1
        if args.save_every and it % args.save_every == 0:
            save()

    save()
    logger.close()
    print(f"saved {path}")
    return trainer, state, path


if __name__ == "__main__":
    main()
