"""Standalone word-recognizer training, the synthetic-word CER floor:
``python -m affganwriting_torch.cli.train_htr --epochs 30``.

The port of ``affganwriting_tpu/cli/train_htr.py`` (the pre-GANwriting
recognizer project's entry, GAN_word/recognizer/main_torch_latest.py): the
seq2seq R alone (``train/htr_trainer.py``) on the synthetic renderer's
words (``data/words.py``) with the marcal augmentation, Adam 2e-4 and
scheduled teacher forcing.  The held-out words are the test split's, drawn
by writer seeds the train set never renders, without augmentation.  Saves
R's best state dict to ``<logdir>/htr_final`` with ``torch.save`` (written
aside, then renamed), logs ``metrics.jsonl``, and prints the best held-out
CER as one JSON line, which ``main`` returns.  The configuration is
``default_config()``; runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from affganwriting_torch.core.config import default_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-writers", type=int, default=500,
                   help="writer seeds 0..N-1 render the train set")
    p.add_argument("--eval-words", type=int, default=256)
    p.add_argument("--no-augment", dest="augment", action="store_false",
                   default=True, help="disable the marcal pipeline")
    p.add_argument("--logdir", default="runs/htr_word")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import json
    import os

    import numpy as np
    import torch

    from affganwriting_torch.core.config import VOCAB
    from affganwriting_torch.data.augment import marcal_augment
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        parse_groundtruth,
    )
    from affganwriting_torch.data.words import synthetic_word_image
    from affganwriting_torch.eval.cer import cer_counts
    from affganwriting_torch.train.htr_trainer import HTRTrainer
    from affganwriting_torch.utils.logging import MetricsLogger

    cfg = default_config()
    trainer = HTRTrainer(cfg, seed=args.seed, device=args.device)
    logger = MetricsLogger(args.logdir)
    rng = np.random.default_rng(args.seed)

    paths = default_reference_paths()
    tr_words = sorted({e.word for ws in parse_groundtruth(
        paths["train_gt"]).values() for e in ws})
    te_words = sorted({e.word for ws in parse_groundtruth(
        paths["test_gt"]).values() for e in ws})
    te_pick = rng.choice(len(te_words), size=min(
        args.eval_words, len(te_words)), replace=False)

    def render(word, writer_seed, augment):
        img = synthetic_word_image(word, writer_seed, cfg.img_height,
                                   cfg.img_width)
        if augment:
            img01 = (img + 1.0) * 0.5
            img = marcal_augment(img01, rng).astype(np.float32) * 2.0 - 1.0
        return img

    def make_batch(words, writer_seeds, augment):
        img = np.stack([render(w, s, augment)
                        for w, s in zip(words, writer_seeds)])[..., None]
        lab = np.asarray([VOCAB.pad_label(w, cfg.output_max_len)
                          for w in words], np.int32)
        return img.astype(np.float32), lab

    eval_words = [te_words[int(i)] for i in te_pick]
    eval_seeds = [args.train_writers + 7 * i for i in range(len(eval_words))]

    @torch.inference_mode()
    def eval_cer():
        rec = trainer.rec.eval()
        ed_sum, len_sum = 0, 0
        for i in range(0, len(eval_words), args.batch_size):
            img, lab = make_batch(eval_words[i: i + args.batch_size],
                                  eval_seeds[i: i + args.batch_size],
                                  augment=False)
            x = torch.from_numpy(img).to(trainer.device).permute(0, 3, 1, 2)
            y = torch.from_numpy(lab).to(trainer.device).long()
            logits, _ = rec(x, y)
            ed, ln = cer_counts(logits.argmax(-1), y[:, 1:])
            ed_sum += int(ed)
            len_sum += int(ln)
        return 100.0 * ed_sum / max(len_sum, 1)

    def train_batches():
        for _ in range(args.steps_per_epoch):
            ws = [tr_words[int(i)] for i in rng.integers(
                len(tr_words), size=args.batch_size)]
            ss = [int(s) for s in rng.integers(
                args.train_writers, size=args.batch_size)]
            img, lab = make_batch(ws, ss, args.augment)
            yield {"image": img, "labels": lab}

    path = os.path.abspath(os.path.join(args.logdir, "htr_final"))

    def save():
        tmp = path + ".new"
        torch.save({"model": trainer.rec.state_dict(),
                    "config": cfg.to_json()}, tmp)
        os.replace(tmp, path)

    best = float("inf")
    for epoch in range(args.epochs):
        m = trainer.train_epoch(train_batches(), epoch,
                                total_epochs=args.epochs)
        cer_te = eval_cer()
        logger.log(epoch, {"loss": m["loss"], "cer_tr": m["cer"],
                           "cer_te": cer_te,
                           "teacher_rate": m["teacher_rate"]}, group="htr")
        if cer_te < best:
            best = cer_te
            save()

    result = {"htr_floor_cer_te": round(best, 3), "epochs": args.epochs,
              "eval_words": len(eval_words), "augment": args.augment}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
