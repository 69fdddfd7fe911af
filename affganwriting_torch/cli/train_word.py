"""Train the word-level AFFGAN on the card:
``python -m affganwriting_torch.cli.train_word``.

The port of ``affganwriting_tpu/cli/train_word.py``.  Without
``--image-root`` the words are rendered synthetically (``data/words.py``).
The configuration is ``default_config()`` with the flags' values, as in
the JAX CLI; ``--device cpu`` runs it on the CPU.  ``build_trainer(argv)``
returns the trainer (resumed from ``<logdir>/ckpt/latest`` when there is
one) and the epoch count; ``main`` fits it and returns it.

``--style-encoder`` takes every key of ``models/style_encoders``.
``--recognizer trocr`` trains against the TrOCR drop-in R, frozen
(``rec_frozen``: G gets its gradient, R keeps its weights), at
``--trocr-preset`` (tiny by default) with random weights.
``--trocr-ckpt DIR`` imports a local HF checkpoint into it, as the JAX CLI
does: it needs ``--recognizer trocr``, forces the base dimensions (refusing
``--trocr-preset tiny``), takes the char->token table from the
directory's tokenizer, and refuses a directory it cannot read.

``--mesh`` trains over one process per device: ``python -m
torch.distributed.run --nproc-per-node N -m
affganwriting_torch.cli.train_word --mesh N`` (data parallel; ``DxM``
puts M-way tensor parallelism of the text encoder's FC pyramid and the
mix inside each of D data groups), NCCL on the cards, gloo with
``--device cpu``.  ``--batch-size`` is the global batch; every rank keeps
its slice of it (``train/loop.py``), and rank 0 writes the checkpoints,
metrics and sheets.  Without the launcher any ``--mesh`` but ``none`` or
``1`` fails, naming it.
"""

from __future__ import annotations

import argparse

from affganwriting_torch.core.config import default_config
from affganwriting_torch.models.style_encoders import available


def trocr_settings(args) -> tuple[dict, dict | None]:
    """(config fields, ``TrOCRCore`` state dict or None) of the TrOCR flags,
    under the JAX CLI's rules (affganwriting_tpu/cli/train_word.py:71-113):
    the pretrained import happens before the trainer exists, so that its
    tokenizer's table reaches the R the step is built with."""
    fields = {"recognizer": args.recognizer,
              "rec_frozen": args.recognizer == "trocr",
              "trocr_preset": args.trocr_preset or "tiny"}
    if not args.trocr_ckpt:
        return fields, None
    if args.recognizer != "trocr":
        raise SystemExit(
            "--trocr-ckpt requires --recognizer trocr: the loaded weights "
            f"cannot drive a '{args.recognizer}' recognizer")
    if args.trocr_preset == "tiny":
        raise SystemExit("--trocr-ckpt holds base-handwritten dims; it "
                         "cannot load into --trocr-preset tiny")
    from affganwriting_torch.models.recognizer.trocr import load_pretrained

    loaded = load_pretrained(args.trocr_ckpt)
    if loaded is None:
        raise SystemExit(f"--trocr-ckpt {args.trocr_ckpt}: not a readable "
                         "local HF checkpoint directory")
    state, mv, vm = loaded
    fields.update(trocr_preset="base",
                  trocr_map_vec=tuple(int(x) for x in mv),
                  trocr_valid_mask=tuple(bool(x) for x in vm))
    return fields, state


def build_trainer(argv=None):
    """(``WordGanTrainer`` of the command line ``argv``, ``--epochs``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--style-encoder", default="resnet50",
                   choices=available())
    p.add_argument("--recognizer", default="seq2seq",
                   choices=("seq2seq", "trocr"))
    p.add_argument("--trocr-preset", default=None, choices=("tiny", "base"),
                   help="TrOCR dims when --recognizer trocr (default tiny; "
                        "base when --trocr-ckpt is given)")
    p.add_argument("--trocr-ckpt", default=None,
                   help="local HF TrOCR checkpoint dir to import weights")
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
    p.add_argument("--mesh", default="none",
                   help="'none', 'auto', 'N' or 'DxM', one process per "
                        "device under torch.distributed.run")
    p.add_argument("--restart-rss-gb", type=float, default=48.0,
                   help="host-RSS watchdog: save latest and re-exec (resume) "
                        "past this RSS; 0 disables")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    trocr_fields, trocr_state = trocr_settings(args)
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.parallel.multihost import mesh_from_flag

    resolve_device(args.device)
    mesh = mesh_from_flag(args.mesh, args.device)

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
        merge_dg=args.merge_dg, **trocr_fields)
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
        restart_rss_gb=args.restart_rss_gb, device=args.device, mesh=mesh)
    if trocr_state is not None:
        trainer.state.rec.model.core.load_state_dict(trocr_state)
    return trainer, args.epochs


def main(argv=None):
    trainer, epochs = build_trainer(argv)
    trainer.fit(epochs)
    return trainer


if __name__ == "__main__":
    main()
