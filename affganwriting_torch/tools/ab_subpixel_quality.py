"""Quality A/B of the subpixel fast decoder against the exact one, on one
checkpoint of the port.

    python3 -m affganwriting_torch.tools.ab_subpixel_quality \\
        --ckpt runs/word/ckpt [--ckpt-name best] [--writers 8] [--words 64] \\
        [--split test] [--seed 0] [--device cpu]

The port of ``scripts/ab_subpixel_quality.py``.  The fast decoder runs each
upsample + 5x5 conv as its subpixel decomposition and the head in phase
layout: exact inside, but the 2-pixel reflect borders are approximated at
low resolution (``models/decoder.py``).  Here G is built twice on one
parameter set (``subpixel_upsample`` True and False), the same words are
generated from the same writers' style stacks through both, the same R
reads them, and the JSON line gives each mode's CER against the requested
words (``eval/generated.cer_of_pairs``), ``delta_cer_fast_minus_exact``,
and the images' mean squared difference and correlation, averaged over the
stacks.  The question it answers needs trained weights; on random ones the
numbers only show that both paths run.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def subpixel_ab(config, gen_state, rec_state, stacks, labels,
                device=None) -> dict:
    """G in both decoder modes from ``gen_state``, R from ``rec_state``;
    each of ``stacks`` (1, H, W, 50) styles every word of ``labels`` (B, T).
    Returns {"fast": {cer...}, "exact": {cer...},
    "delta_cer_fast_minus_exact", "image_mse", "image_corr", "images":
    {mode: [(B, H, W, 1) per stack]}}; the targets are the words that
    ``labels`` encode."""
    import torch

    from affganwriting_torch.core.config import VOCAB
    from affganwriting_torch.eval.generated import cer_of_pairs
    from affganwriting_torch.gen.inference import (
        build_generator,
        build_recognizer,
        generate_images,
        resolve_device,
    )

    dev = resolve_device(device)
    rec = build_recognizer(config, dev, state=rec_state)
    gens = {"fast": build_generator(config, dev, state=gen_state),
            "exact": build_generator(config, dev, state=gen_state,
                                     subpixel=False)}
    lab = torch.as_tensor(np.asarray(labels), device=dev).long()
    words = [VOCAB.decode(row[1:]) for row in np.asarray(labels)]
    pairs = {k: [] for k in gens}
    images = {k: [] for k in gens}
    mse = corr = 0.0
    with torch.inference_mode():
        for stack in stacks:
            for k, gen in gens.items():
                imgs = generate_images(gen, stack, lab, dev)
                logits, _ = rec(imgs.permute(0, 3, 1, 2), lab)
                ids = logits.argmax(-1).cpu().numpy()
                images[k].append(imgs.float().cpu().numpy())
                pairs[k] += [(w, VOCAB.decode(ids[i]) or "x")
                             for i, w in enumerate(words)]
            a, b = images["fast"][-1], images["exact"][-1]
            mse += float(np.mean((a - b) ** 2))
            corr += float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    res = {k: cer_of_pairs(v) for k, v in pairs.items()}
    n = max(len(stacks), 1)
    return {"fast": res["fast"], "exact": res["exact"],
            "delta_cer_fast_minus_exact":
                res["fast"]["cer"] - res["exact"]["cer"],
            "image_mse": mse / n, "image_corr": corr / n,
            "images": images}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--writers", type=int, default=8)
    p.add_argument("--words", type=int, default=64)
    p.add_argument("--split", choices=("train", "test"), default="test")
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
    from affganwriting_torch.gen.inference import (
        encode_labels,
        resolve_device,
    )

    dev = resolve_device(args.device)
    ck = CheckpointManager(args.ckpt)
    cfg = ck.load_config(args.ckpt_name)
    payload = ck.load(args.ckpt_name, "cpu")
    paths = default_reference_paths()
    words = [w[: cfg.max_chars] for w in load_corpus(paths["oov_corpus"])
             if w and all(c in VOCAB.letters for c in w)][: args.words]
    gt = parse_groundtruth(
        paths["train_gt" if args.split == "train" else "test_gt"])
    ds = WordStyleDataset(gt, writer_label_map(gt), cfg, corpus=None,
                          image_root=args.image_root, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    stacks = [ds.style_stack(w, rng) for w in list(gt)[: args.writers]]
    res = subpixel_ab(cfg, payload["gen"]["model"], payload["rec"]["model"],
                      stacks, encode_labels(words, cfg.output_max_len), dev)
    del res["images"]
    out = {"ckpt": os.path.join(args.ckpt, args.ckpt_name),
           "writers": len(stacks), "words": len(words), **res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
