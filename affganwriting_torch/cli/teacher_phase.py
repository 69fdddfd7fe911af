"""The teacher phase on a trained word checkpoint, with R's held-out CER
before and after: ``python -m affganwriting_torch.cli.teacher_phase --ckpt
runs/word_gan/ckpt``.

The port of ``affganwriting_tpu/cli/teacher_phase.py`` (the reference's
post-GAN teacher stage, GAN_word/main_run.py:310-410): restore the
checkpoint through ``core/checkpoint.py``, generate words in the training
writers' styles, read them with the teacher (the host HF ``TrOCRTeacher``
from ``--trocr-dir``, else a ``SelfTeacher`` copy of R with beam 3), keep
the confident ones as pseudo labels and fine-tune R on them
(``train/teacher.py:run_teacher_phase``).  Writes ``<out>/report.json`` and
prints it as one JSON line; ``main`` returns it.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="CheckpointManager dir")
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--trocr-dir", default=None,
                   help="local TrOCR snapshot for the teacher; the port's "
                        "own beam recognizer (SelfTeacher) when absent")
    p.add_argument("--max-steps", type=int, default=100)
    p.add_argument("--conf-threshold", type=float, default=0.6)
    p.add_argument("--eval-batches", type=int, default=40)
    p.add_argument("--out", default="runs/teacher_phase")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import json
    import os

    import torch

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.eval.cer import CERAccumulator
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.train.eval_step import make_eval_step
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.teacher import (
        SelfTeacher,
        TrOCRTeacher,
        run_teacher_phase,
    )

    dev = resolve_device(args.device)
    ckpt = CheckpointManager(args.ckpt)
    cfg = ckpt.load_config(args.ckpt_name)
    state = ckpt.restore(args.ckpt_name,
                         init_state(cfg, dev, seed=args.seed))

    paths = default_reference_paths()
    tr_gt = parse_groundtruth(paths["train_gt"])
    te_gt = parse_groundtruth(paths["test_gt"])
    tr_ds = WordStyleDataset(tr_gt, writer_label_map(tr_gt), cfg,
                             seed=args.seed)
    te_ds = WordStyleDataset(te_gt, writer_label_map(te_gt), cfg,
                             seed=args.seed + 1)
    eval_step = make_eval_step(cfg, device=dev)

    def eval_cer(state):
        """Held-out generated-word CER: the trainer's early-stop monitor's
        two halves (train/loop.py:evaluate)."""
        cers = {"cer_te": CERAccumulator(), "cer_te2": CERAccumulator()}
        for i, batch in enumerate(te_ds.batches(epoch=0, shuffle=False)):
            if i >= args.eval_batches:
                break
            _, preds, _ = eval_step(state, batch)
            for key, pk, lk in (("cer_te", "pred_xt", "label_xt"),
                                ("cer_te2", "pred_swap", "label_xt_swap")):
                cers[key].add(preds[pk], torch.as_tensor(batch[lk],
                                                          device=dev))
        return {k: acc.value() for k, acc in cers.items()}

    before = eval_cer(state)
    print(f"before: cer_te={before['cer_te']:.2f} "
          f"cer_te2={before['cer_te2']:.2f}", flush=True)

    if args.trocr_dir:
        teacher = TrOCRTeacher(args.trocr_dir)
        teacher_kind = f"trocr:{args.trocr_dir}"
    else:
        teacher = SelfTeacher(cfg, state.rec.model)
        teacher_kind = "self(beam)"

    def style_batches():
        epoch = 0
        while True:
            yield from tr_ds.batches(epoch=epoch)
            epoch += 1

    generator = torch.Generator(device=dev).manual_seed(args.seed + 2)
    state, stats = run_teacher_phase(
        state, cfg, teacher, style_batches(), generator,
        max_steps=args.max_steps, conf_threshold=args.conf_threshold)
    print(f"teacher phase: {stats}", flush=True)
    after = eval_cer(state)
    print(f"after: cer_te={after['cer_te']:.2f} "
          f"cer_te2={after['cer_te2']:.2f}", flush=True)

    report = {
        "ckpt": f"{args.ckpt}:{args.ckpt_name}",
        "teacher": teacher_kind,
        "conf_threshold": args.conf_threshold,
        "max_steps": args.max_steps,
        "eval_batches": args.eval_batches,
        "before": before,
        "after": after,
        "delta_cer_te": after["cer_te"] - before["cer_te"],
        "phase_stats": stats,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
