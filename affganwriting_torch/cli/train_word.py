"""Train the word-level AFFGAN on the card:
``python -m affganwriting_torch.cli.train_word``.

The port of ``affganwriting_tpu/cli/train_word.py``.  Without
``--image-root`` the words are rendered synthetically (``data/words.py``).
The configuration is ``default_config()`` with the flags' values, as in
the JAX CLI; ``--device cpu`` runs it on the CPU.  ``build_trainer(argv)``
returns the trainer (resumed from ``<logdir>/ckpt/latest`` when there is
one) and the epoch count; ``main`` fits it and returns it.

Not ported yet, each refused with the ROADMAP item it waits for: ``--mesh``
(Queue 1 item 10), ``--recognizer trocr`` and ``--trocr-*`` (item 8), style
encoders other than resnet50 and resnet18 (item 8).
"""

from __future__ import annotations

import argparse

from affganwriting_torch.core.config import default_config

ENCODERS = ("resnet50", "resnet18")


def refuse_unported(args) -> None:
    """Raise ``SystemExit`` for a flag value the port does not have yet."""
    if getattr(args, "mesh", "none") != "none":
        raise SystemExit("--mesh: the multi-device port waits for ROADMAP "
                         "Queue 1 item 10; run without --mesh")
    if getattr(args, "recognizer", None) not in (None, "seq2seq") or \
            getattr(args, "trocr_preset", None) or \
            getattr(args, "trocr_ckpt", None):
        raise SystemExit("the TrOCR recognizer waits for ROADMAP Queue 1 "
                         "item 8; the port has --recognizer seq2seq")
    if args.style_encoder not in (None, *ENCODERS):
        raise SystemExit(f"--style-encoder {args.style_encoder}: the port has "
                         f"{', '.join(ENCODERS)}; the other encoders wait for "
                         "ROADMAP Queue 1 item 8")


def build_trainer(argv=None):
    """(``WordGanTrainer`` of the command line ``argv``, ``--epochs``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--style-encoder", default="resnet50",
                   help="resnet50 or resnet18")
    p.add_argument("--recognizer", default="seq2seq",
                   choices=("seq2seq", "trocr"))
    p.add_argument("--trocr-preset", default=None, choices=("tiny", "base"))
    p.add_argument("--trocr-ckpt", default=None)
    p.add_argument("--oov", action="store_true", default=True)
    p.add_argument("--no-oov", dest="oov", action="store_false")
    p.add_argument("--image-root", default=None,
                   help="IAM word images dir (<img_id>.png); synthetic if "
                        "unset")
    p.add_argument("--logdir", default="runs/word_gan")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--no-merge-dg", dest="merge_dg", action="store_false",
                   default=True,
                   help="run D's and G's phases apart (train/step.py)")
    p.add_argument("--rec-plateau", action="store_true",
                   help="ReduceLROnPlateau on R's lr (main_run.py:279)")
    p.add_argument("--max-writers", type=int, default=None,
                   help="restrict to the first N writers of each split")
    p.add_argument("--mesh", default="none")
    p.add_argument("--restart-rss-gb", type=float, default=48.0,
                   help="host-RSS watchdog: save latest and re-exec (resume) "
                        "past this RSS; 0 disables")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    refuse_unported(args)

    from affganwriting_torch.data.iam import (
        default_reference_paths,
        load_corpus,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.train.loop import WordGanTrainer

    cfg = default_config().replace(
        batch_size=args.batch_size, style_encoder=args.style_encoder,
        oov=args.oov, compute_dtype=args.compute_dtype,
        merge_dg=args.merge_dg)
    paths = default_reference_paths()
    tr = parse_groundtruth(paths["train_gt"])
    te = parse_groundtruth(paths["test_gt"])
    if args.max_writers:
        tr = dict(list(tr.items())[: args.max_writers])
        te = dict(list(te.items())[: args.max_writers])
    corpus = load_corpus(paths["corpus"])
    train_ds = WordStyleDataset(
        tr, writer_label_map(tr), cfg, corpus=corpus,
        image_root=args.image_root, seed=args.seed)
    test_ds = WordStyleDataset(
        te, writer_label_map(te), cfg, corpus=corpus,
        image_root=args.image_root, seed=args.seed + 1)
    trainer = WordGanTrainer(
        cfg, train_ds, test_ds, logdir=args.logdir, seed=args.seed,
        eval_every=args.eval_every, save_every=args.save_every,
        patience=args.patience, rec_plateau=args.rec_plateau,
        restart_rss_gb=args.restart_rss_gb, device=args.device)
    return trainer, args.epochs


def main(argv=None):
    trainer, epochs = build_trainer(argv)
    trainer.fit(epochs)
    return trainer


if __name__ == "__main__":
    main()
