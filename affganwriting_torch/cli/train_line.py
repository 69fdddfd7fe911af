"""Train the line-level GAN on the card:
``python -m affganwriting_torch.cli.train_line``.

The port of ``affganwriting_tpu/cli/train_line.py`` (the reference's
line_generation/train.py, ``python train.py -c config.json``): the JAX
CLI's flags, ``--config`` and ``-a`` overrides, and ``--device`` (default
the card; ``cpu`` runs on the CPU).  The curriculum is the reference's
count/gen/auto/disc rotation; the lines are synthetic
(``data/lines.LineDataset``) unless ``--xml-root`` names an IAM form-XML
directory (``data/parse_iam``: its ``--split`` for training, ``valid``
for validation, the form pages from ``--image-root``).
``--pretrained-hwr`` and ``--pretrained-ae`` (or the config's
``model.pretrained_hwr`` and ``trainer.encoder_weights``) splice the
``hwr_final`` of ``cli/train_hwr`` and the ``ae_final`` of
``cli/train_auto`` into the frozen recognizer and AE.  Runtime: ``latest``
every ``--save-latest-every`` iterations, periodic keeps every
``--save-every``, validation with monitor-best every ``--val-every``, SWA
past ``--swa-start``, a full resume (model, both optimizers, iteration and
SWA) from ``<logdir>/ckpt/latest`` unless ``--no-resume``.

``--mesh N`` trains data-parallel over N processes, one per device:
``python -m torch.distributed.run --nproc-per-node N -m
affganwriting_torch.cli.train_line --mesh N ...`` (NCCL on the cards;
with ``--device cpu`` gloo on the CPU).  Each rank draws the same global
batches of ``--batch-authors`` x ``--a-batch-size`` lines and trains on
its slice (``train/line_trainer.py``); rank 0 writes the checkpoints,
metrics and sheets.  Without the launcher any ``--mesh`` but ``none`` or
``1`` fails, naming it.
"""

from __future__ import annotations

import argparse


def _latest_exists(ckpt, mesh) -> bool:
    """Whether ``latest`` exists, read after rank 0 has finished any swap
    a crash left half done."""
    if mesh is not None:
        import torch.distributed as dist

        if ckpt.write:
            ckpt.latest_exists()
        dist.barrier()
    return ckpt.latest_exists()


def make_dataset(args, charset, split: str, seed: int):
    """The IAM lines of ``split`` under ``--xml-root``, else the synthetic
    lines."""
    if args.xml_root:
        from affganwriting_torch.data.parse_iam import (
            AuthorLineDataset,
            AuthorLinesIndex,
        )

        index = AuthorLinesIndex(args.xml_root, split=split)
        return AuthorLineDataset(
            index, args.image_root or args.xml_root, charset,
            a_batch_size=args.a_batch_size, seed=seed)
    from affganwriting_torch.data.lines import LineDataset

    return LineDataset(charset, a_batch_size=args.a_batch_size,
                       width=args.width, seed=seed)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None,
                   help="cf_<name>.json recipe (core/line_config.py); its "
                        "model/trainer/optimizer keys override the flag "
                        "defaults")
    p.add_argument("-a", dest="overrides", action="append", default=[],
                   metavar="KEY.PATH=VALUE",
                   help="dotted-path config override (generate.py:116-138)")
    p.add_argument("--iterations", type=int, default=240_000)
    p.add_argument("--batch-authors", type=int, default=2)
    p.add_argument("--a-batch-size", type=int, default=2)
    p.add_argument("--max-gen-length", type=int, default=500)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--logdir", default="runs/line_gan")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--xml-root", default=None,
                   help="IAM form-XML dir (real data path); synthetic "
                        "lines when absent")
    p.add_argument("--image-root", default=None,
                   help="IAM form images dir (default: --xml-root)")
    p.add_argument("--split", default="train",
                   choices=("train", "valid", "test"))
    p.add_argument("--mesh", default="none",
                   help="'none', 'auto' or 'N' (N-way data parallel, one "
                        "process per device under torch.distributed.run)")
    p.add_argument("--save-every", type=int, default=2000)
    p.add_argument("--save-latest-every", type=int, default=250)
    p.add_argument("--val-every", type=int, default=1000,
                   help="validation cadence; 0 disables")
    p.add_argument("--val-batches", type=int, default=4)
    p.add_argument("--swa-start", type=int, default=None)
    p.add_argument("--no-resume", dest="resume", action="store_false",
                   default=True)
    p.add_argument("--sheet-every", type=int, default=2000,
                   help="periodic real|recon|gen sheet cadence; 0 disables")
    p.add_argument("--restart-rss-gb", type=float, default=48.0,
                   help="host-RSS watchdog: save latest + re-exec (resume) "
                        "past this RSS; 0 disables")
    p.add_argument("--pretrained-hwr", default=None,
                   help="a cli/train_hwr 'hwr_final' to load (frozen) into "
                        "the recognizer slot (hw_with_style.py:182-194)")
    p.add_argument("--char-style-dim", type=int, default=0,
                   help="per-character private style size; > 0 selects the "
                        "multi-style extractor")
    p.add_argument("--pretrained-ae", default=None,
                   help="a cli/train_auto 'ae_final' to load (frozen) into "
                        "the perceptual-AE slot (the reference's trainer "
                        "encoder_weights, hw_with_style_trainer.py:139-149)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    if args.config:
        from affganwriting_torch.core.line_config import load_config

        cf = load_config(args.config, args.overrides)
        m = cf.get("model", {})
        t = cf.get("trainer", {})
        d = cf.get("data_loader", {})
        args.char_style_dim = m.get("char_style_dim", args.char_style_dim)
        args.max_gen_length = m.get("max_gen_length", args.max_gen_length)
        args.pretrained_hwr = m.get("pretrained_hwr", args.pretrained_hwr)
        args.iterations = t.get("iterations", args.iterations)
        args.swa_start = t.get("swa_start", args.swa_start)
        args.val_every = t.get("val_step", args.val_every)
        args.save_every = t.get("save_step", args.save_every)
        args.save_latest_every = t.get(
            "save_step_minor", args.save_latest_every)
        args.pretrained_ae = t.get("encoder_weights", args.pretrained_ae)
        args.lr = cf.get("optimizer", {}).get("lr", args.lr)
        args.batch_authors = d.get("batch_size", args.batch_authors)
        args.a_batch_size = d.get("a_batch_size", args.a_batch_size)
    return args


def main(argv=None):
    """Train; returns (trainer, final state).  The trainer resumes from
    ``<logdir>/ckpt/latest`` unless ``--no-resume``."""
    from affganwriting_torch.core.checkpoint import (
        LineCheckpointManager,
        restore_line_trainer,
    )
    from affganwriting_torch.data.lines import LineCharset
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.parallel.multihost import (
        is_writer,
        mesh_from_flag,
    )
    from affganwriting_torch.train.line_trainer import LineGanTrainer
    from affganwriting_torch.utils.logging import MetricsLogger, NullLogger

    args = parse(argv)
    resolve_device(args.device)
    mesh = mesh_from_flag(args.mesh, args.device)
    writer = is_writer(mesh)
    charset = LineCharset()
    ds = make_dataset(args, charset, args.split, args.seed)
    val_ds = make_dataset(args, charset,
                          "valid" if args.xml_root else args.split,
                          args.seed + 1)
    ckpt_dir = f"{args.logdir}/ckpt"
    ckpt = LineCheckpointManager(ckpt_dir, write=writer)
    first = next(ds.batches(batch_authors=args.batch_authors))
    swa_state, start_iteration = None, None
    if args.resume and _latest_exists(ckpt, mesh):
        trainer, payload = restore_line_trainer(ckpt_dir, first, "latest",
                                                device=args.device,
                                                mesh=mesh)
        state = payload["state"]
        swa_state = payload["swa"]
        if int(swa_state["count"]) == 0:
            swa_state = None   # the placeholder slot: SWA never started
        start_iteration = int(payload["iteration"])
        print(f"resumed from latest at iteration {start_iteration}")
    else:
        trainer = LineGanTrainer(
            n_class=charset.n_class, max_gen_length=args.max_gen_length,
            lr=args.lr, seed=args.seed, iterations=args.iterations,
            pretrained_hwr=args.pretrained_hwr,
            pretrained_ae=args.pretrained_ae,
            char_style_dim=args.char_style_dim, device=args.device,
            mesh=mesh)
        state = trainer.init_state(first)

    def stream():
        epoch = 0
        while True:
            yield from ds.batches(args.batch_authors, epoch=epoch)
            epoch += 1

    def val_batches():
        return val_ds.batches(args.batch_authors, epoch=0)

    state = trainer.fit(
        state, stream(), args.iterations,
        logger=MetricsLogger(args.logdir) if writer else NullLogger(),
        ckpt=ckpt,
        save_every=args.save_every,
        save_latest_every=args.save_latest_every,
        val_batches_fn=val_batches if args.val_every else None,
        val_every=args.val_every, val_max_batches=args.val_batches,
        swa_start=args.swa_start, swa_state=swa_state,
        start_iteration=start_iteration,
        sheet_every=args.sheet_every, sheet_dir=f"{args.logdir}/sheets",
        restart_rss_gb=args.restart_rss_gb)
    return trainer, state


if __name__ == "__main__":
    main()
