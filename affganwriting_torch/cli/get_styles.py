"""Build a style library pickle: the reference's get_styles.py surface.

The port of ``affganwriting_tpu/cli/get_styles.py``: ``python -m
affganwriting_torch.cli.get_styles --out styles.pkl`` runs the style
extractor over synthetic lines of ``--n-authors`` writers and writes
{styles, authors, ids}; ``--eval-writer-id`` also prints top-1/5/20
writer retrieval (line_generation/get_styles.py:19-140,
eval_writer_id.py:15-91).  As in the JAX CLI the extractor has random
weights from ``--seed``; ``--ckpt DIR`` (a ``train_line`` checkpoint
directory, the port's addition) takes a trained one, ``best`` when there
is one, else ``latest``.  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="styles.pkl")
    p.add_argument("--n-authors", type=int, default=8)
    p.add_argument("--a-batch-size", type=int, default=2)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-writer-id", action="store_true")
    p.add_argument("--ckpt", default=None,
                   help="train_line checkpoint directory (<logdir>/ckpt)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from affganwriting_torch.core.checkpoint import restore_line_trainer
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.gen.line_inference import (
        extract_styles,
        writer_retrieval,
    )
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    resolve_device(args.device)
    charset = LineCharset()
    authors = [f"a{i:03d}" for i in range(args.n_authors)]
    ds = LineDataset(charset, authors=authors,
                     a_batch_size=args.a_batch_size, width=args.width,
                     seed=args.seed)
    first = next(ds.batches(batch_authors=2))
    if args.ckpt:
        name = "best" if os.path.exists(os.path.join(args.ckpt, "best")) \
            else "latest"
        trainer, payload = restore_line_trainer(args.ckpt, first, name,
                                                device=args.device)
        state = payload["state"]
    else:
        trainer = LineGanTrainer(n_class=charset.n_class, max_gen_length=64,
                                 seed=args.seed, device=args.device)
        state = trainer.init_state(first)
    library = extract_styles(trainer, state, ds.batches(batch_authors=2))
    library.save(args.out)
    print(f"wrote {len(library.styles)} styles "
          f"({len(library.by_author)} authors) to {args.out}")
    if args.eval_writer_id:
        print(json.dumps(writer_retrieval(library)))
    return library


if __name__ == "__main__":
    main()
