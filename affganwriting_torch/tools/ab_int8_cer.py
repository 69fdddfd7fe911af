"""CER gate of the w8a8 serving mode: the int8 pipeline against the bf16
one on a trained checkpoint of the port.

    python3 -m affganwriting_torch.tools.ab_int8_cer --ckpt runs/word/ckpt \\
        [--ckpt-name best] [--writers 8] [--words 64] [--split test] \\
        [--corpus oov] [--device cpu]

The port of ``scripts/ab_int8_cer.py``: the same words in the same
writers' styles through ``make_generate_and_read_fn`` (bf16) and through
``make_generate_and_read_quant_fn(quant_gen="static")`` (R's trunk and
G's decoder convs in int8), both halves calibrated once on the first
writer's batch; the generated words' CER against the requested text
(``eval/generated.cer_of_pairs``) for each, and the share of greedy ids the
two agree on.  Prints one JSON line ``{"bf16": {...}, "int8": {...},
"delta_cer": ..., "pred_token_agreement": ...}`` and returns it.  The
int8 mode may become the serving default only when ``delta_cer`` is under
1 CER point on trained weights.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--writers", type=int, default=8)
    p.add_argument("--words", type=int, default=64)
    p.add_argument("--split", choices=("train", "test"), default="test")
    p.add_argument("--corpus", choices=("in_vocab", "oov"), default="oov")
    p.add_argument("--image-root", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.core.config import VOCAB
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        load_corpus,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.eval.generated import cer_of_pairs
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_quant_fn,
        resolve_device,
    )

    dev = resolve_device(args.device)
    ck = CheckpointManager(args.ckpt)
    cfg = ck.load_config(args.ckpt_name)
    payload = ck.load(args.ckpt_name, "cpu")
    run = make_generate_and_read_quant_fn(
        cfg, payload["gen"]["model"], payload["rec"]["model"],
        quant_gen="static", device=dev)
    del payload

    paths = default_reference_paths()
    gt = parse_groundtruth(
        paths["train_gt" if args.split == "train" else "test_gt"])
    label_map = writer_label_map(gt)
    ds = WordStyleDataset(gt, label_map, cfg, corpus=None,
                          image_root=args.image_root, seed=args.seed)
    corpus = (paths["oov_corpus"] if args.corpus == "oov" else
              os.path.join(os.path.dirname(paths["corpus"]),
                           "in_vocab.subset.tro.37"))
    words = [w[: cfg.max_chars] for w in load_corpus(corpus)
             if w and all(c in VOCAB.letters for c in w)][: args.words]
    labels = encode_labels(words, cfg.output_max_len)

    rng = np.random.default_rng(args.seed)
    stacks = [ds.style_stack(w, rng) for w in list(gt)[: args.writers]]

    # serving calibrates once, on the first writer's batch, then styles vary
    run.calibrate(stacks[0], labels)
    pairs_bf16, pairs_int8 = [], []
    agree = total = 0
    for stack in stacks:
        ids_b = run.base(stack, labels)[1].cpu().numpy()
        ids_q = run(stack, labels)[1].cpu().numpy()
        agree += int((ids_b == ids_q).sum())
        total += ids_b.size
        for i, w in enumerate(words):
            pairs_bf16.append((w, VOCAB.decode(ids_b[i]) or "x"))
            pairs_int8.append((w, VOCAB.decode(ids_q[i]) or "x"))
    r_b, r_q = cer_of_pairs(pairs_bf16), cer_of_pairs(pairs_int8)
    out = {"ckpt": os.path.join(args.ckpt, args.ckpt_name),
           "writers": len(stacks), "words": len(words),
           "corpus": args.corpus, "split": args.split,
           "bf16": r_b, "int8": r_q,
           "delta_cer": round(r_q["cer"] - r_b["cer"], 3),
           "pred_token_agreement": round(agree / max(total, 1), 4)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
