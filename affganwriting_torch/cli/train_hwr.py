"""Pretrain the line CTC recognizer (the reference's run_hwr path):
``python -m affganwriting_torch.cli.train_hwr --iterations 1000``.

The port of ``affganwriting_tpu/cli/train_hwr.py``: line_generation
pretrains a CNNOnly/CRNN recognizer with CTC alone
(hw_with_style_trainer.py:503-520, config cf_IAM_hwr_cnnOnly_batchnorm_aug)
and freezes it for GAN training.  This CLI does the same over the
synthetic line batches (``data/lines.LineDataset``), with the JAX CLI's
flags and ``--device`` (default the card; ``cpu`` runs on the CPU): Adam
at ``--lr`` (b1 0.9, b2 0.999), the recognizer in train mode, so that its
BatchNorm normalizes with the batch's statistics and moves its running
ones (flax's rule, ``models/blocks.BatchNorm``).  Its convolutions compute
in bf16 on f32 parameters, as the JAX CLI's recognizer does (the flax
class's default dtype).  Neither arch has a dropout layer (the JAX step's
dropout key reaches none).

``<logdir>/hwr_final`` is refreshed every ``--save-every`` iterations and
at the end, swap-written (``core/checkpoint.save_swap``): one
``torch.save`` file holding ``{"params": {name: tensor}, "batch_stats":
{name: running statistic}}`` of the recognizer, which ``cli/train_line
--pretrained-hwr`` reads.
"""

from __future__ import annotations

import argparse


def build_hwr(arch: str, norm: str, n_class: int, seed: int, device,
              dtype=None):
    """The recognizer on ``device``, computing in ``dtype`` (default bf16)
    on f32 parameters drawn under ``seed``."""
    import torch

    from affganwriting_torch.models.line.hwr import CNNOnlyHWR, CRNN

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (CNNOnlyHWR if arch == "cnn_only" else CRNN)(
            n_class, norm=norm, dtype=dtype or torch.bfloat16)
    return model.to(device)


def hwr_step(model, opt, img, labels, lengths):
    """One CTC update of ``model`` on an NCHW batch; returns the loss."""
    from affganwriting_torch.train.line_trainer import ctc_loss

    model.train()
    loss = ctc_loss(model(img), labels, lengths)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def hwr_payload(model) -> dict:
    """``{"params", "batch_stats"}`` of ``model`` on the host."""
    return {"params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()},
            "batch_stats": {n: b.detach().cpu()
                            for n, b in model.named_buffers()}}


def main(argv=None):
    """Train; returns (model, the ``hwr_final`` path)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iterations", type=int, default=100_000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--arch", choices=["cnn_only", "crnn"], default="cnn_only")
    p.add_argument("--norm", default="batch")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--logdir", default="runs/hwr")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--save-every", type=int, default=2000,
                   help="refresh hwr_final every N iterations (a crash "
                        "then loses at most N iterations); 0 = end only")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import os

    import torch

    from affganwriting_torch.core.checkpoint import save_swap
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.utils.logging import MetricsLogger

    dev = resolve_device(args.device)
    charset = LineCharset()
    model = build_hwr(args.arch, args.norm, charset.n_class, args.seed, dev)
    ds = LineDataset(charset, a_batch_size=1, width=args.width,
                     seed=args.seed)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    logger = MetricsLogger(args.logdir)
    path = os.path.abspath(os.path.join(args.logdir, "hwr_final"))

    def stream():
        epoch = 0
        while True:
            yield from ds.batches(args.batch_size, epoch=epoch)
            epoch += 1

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    it = 0
    for batch in stream():
        if it >= args.iterations:
            break
        loss = hwr_step(model, opt,
                        put(batch["image"], torch.float32).permute(0, 3, 1, 2),
                        put(batch["label"], torch.long),
                        put(batch["label_lengths"], torch.long))
        if it % args.log_every == 0:
            logger.log(it, {"ctc": float(loss)}, group="hwr")
        it += 1
        if args.save_every and it % args.save_every == 0:
            save_swap(path, hwr_payload(model))

    save_swap(path, hwr_payload(model))
    logger.close()
    print(f"saved {path}")
    return model, path


if __name__ == "__main__":
    main()
