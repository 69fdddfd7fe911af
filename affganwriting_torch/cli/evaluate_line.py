"""Dataset-wide line evaluation:
``python -m affganwriting_torch.cli.evaluate_line --ckpt runs/line_gan/ckpt``.

The port of ``affganwriting_tpu/cli/evaluate_line.py`` (the reference's
``new_eval.py`` surface, new_eval.py:29-45 + evaluators/hwdataset_eval.py):
one command over a split computes the reconstruction L1, the recognizer's
CER/WER on real lines, its CER on generated lines (legibility) and
writer-retrieval accuracy from the extracted style vectors
(``eval/line_eval.evaluate_lines``), printed as one JSON object and
optionally written to a file.  The lines are the IAM ones under
``--xml-root`` (``data/parse_iam``), else synthetic.  The JAX CLI's flags
and ``--device`` (default the card; ``cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Evaluate; returns the result dict."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=None,
                   help="line checkpoint dir; random-init model if absent "
                        "(useful only for smoke runs)")
    p.add_argument("--ckpt-name", default="best",
                   choices=("latest", "best"))
    p.add_argument("--xml-root", default=None,
                   help="IAM form-XML dir (real data path); synthetic "
                        "lines when absent")
    p.add_argument("--image-root", default=None)
    p.add_argument("--split", default="valid",
                   choices=("train", "valid", "test"))
    p.add_argument("--batch-authors", type=int, default=2)
    p.add_argument("--a-batch-size", type=int, default=2)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--max-batches", type=int, default=8)
    p.add_argument("--out", default=None, help="write the JSON here too")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from affganwriting_torch.cli.train_line import make_dataset
    from affganwriting_torch.data.lines import LineCharset
    from affganwriting_torch.eval.line_eval import evaluate_lines
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    resolve_device(args.device)
    charset = LineCharset()
    ds = make_dataset(args, charset, args.split, args.seed)
    batches = ds.batches(batch_authors=args.batch_authors, epoch=0)
    first = next(ds.batches(batch_authors=args.batch_authors))
    if args.ckpt:
        from affganwriting_torch.core.checkpoint import restore_line_trainer

        trainer, payload = restore_line_trainer(
            args.ckpt, first, name=args.ckpt_name, device=args.device)
        state = payload["state"]
        print(f"restored {args.ckpt_name} "
              f"(iteration {int(payload['iteration'])})")
    else:
        trainer = LineGanTrainer(n_class=charset.n_class, max_gen_length=64,
                                 seed=args.seed, device=args.device)
        state = trainer.init_state(first)

    out = evaluate_lines(trainer, state, batches, charset,
                         max_batches=args.max_batches)
    line = json.dumps(out, indent=2, sort_keys=True)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    return out


if __name__ == "__main__":
    main()
