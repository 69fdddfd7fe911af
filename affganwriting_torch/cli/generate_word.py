"""Write the words of a checkpoint's generator in the style of given writers:
``python -m affganwriting_torch.cli.generate_word``.

The port of ``affganwriting_tpu/cli/generate_word.py`` (the reference's
4-scenario test, GAN_word/tt.test_single_writer.4_scenarios.py, and word
ladder, tt.word_ladder.py).  Per writer: a 50-image style stack (its words
shuffled, repeated when fewer, read as the dataset reads them), encoded
once; the corpus generated and read back by R in chunks of
``--words-per-batch`` through ``gen/inference.py:make_generate_and_read_fn``
(the serving path, with its kernels on the card); with ``--beam K`` the
images are read again by R's beam search.  Each word becomes
``<out>/<wid>-<n>.<GT>-<pred>.png`` (``.png.npy`` without PIL).

With ``--ckpt`` the config and the weights come from the checkpoint
(``core/checkpoint.py``); without it, ``default_config()`` with random
weights from ``--seed``.  ``main`` returns ``{"files": [...], "pred_ids":
(N, T - 1) int array, "seconds": the writer loop's seconds}``.  ``--mesh``
waits for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from affganwriting_torch.models.style_encoders import available

WORD_LADDER = ["three", "threw", "shrew", "shred", "sired", "sides",
               "sites", "sines", "wines", "vines", "vised", "vised",
               "fires", "hires", "hived", "haven", "seven"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=None, help="checkpoint dir")
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--out", default="runs/generated")
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--corpus", choices=["in_vocab", "oov", "ladder"],
                   default="oov")
    p.add_argument("--writers", nargs="*", default=None)
    p.add_argument("--max-writers", type=int, default=4)
    p.add_argument("--words-per-batch", type=int, default=128)
    p.add_argument("--image-root", default=None)
    p.add_argument("--style-encoder", default=None, choices=available(),
                   help="default: the checkpoint's config (resnet50)")
    p.add_argument("--beam", type=int, default=0,
                   help="read the generated words with a beam search of "
                        "this width (the reference's 3, modules_tro.py:637)"
                        "; 0: the serving path's greedy reading")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="none")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    from affganwriting_torch.cli.train_word import refuse_unported

    refuse_unported(args)

    import torch

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.core.config import VOCAB, default_config
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        load_corpus,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.eval.sheets import _normalize, _save_png
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_and_read_fn,
        resolve_device,
    )

    dev = resolve_device(args.device)
    states = {"gen": None, "rec": None}
    if args.ckpt:
        ck = CheckpointManager(args.ckpt)
        cfg = ck.load_config(args.ckpt_name)
        payload = ck.load(args.ckpt_name, "cpu")
        states = {k: payload[k]["model"] for k in states}
        del payload
    else:
        cfg = default_config()
    if args.style_encoder:
        cfg = cfg.replace(style_encoder=args.style_encoder)
    paths = default_reference_paths()
    gt = parse_groundtruth(
        paths["train_gt" if args.split == "train" else "test_gt"])
    label_map = writer_label_map(gt)
    ds = WordStyleDataset(gt, label_map, cfg, corpus=None,
                          image_root=args.image_root, seed=args.seed)

    if args.corpus == "ladder":
        words = list(WORD_LADDER)
    elif args.corpus == "oov":
        words = load_corpus(paths["oov_corpus"])
    else:
        words = load_corpus(os.path.join(os.path.dirname(paths["corpus"]),
                                         "in_vocab.subset.tro.37"))
    words = [w for w in words if w and all(c in VOCAB.letters for c in w)]
    words = [w[: cfg.max_chars] for w in words]

    run = make_generate_and_read_fn(cfg, states["gen"], states["rec"],
                                    device=dev, seed=args.seed)
    writers = args.writers or list(gt.keys())[: args.max_writers]
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    files, all_ids = [], []
    t0 = time.perf_counter()
    for wid in writers:
        entries = gt[wid][:]
        rng.shuffle(entries)
        while len(entries) < cfg.style_stack:
            entries = entries + entries[: cfg.style_stack - len(entries)]
        stack = np.stack(
            [ds._read(e, label_map[wid]) for e in entries[: cfg.style_stack]],
            axis=-1)[None].astype(np.float32)
        for start in range(0, len(words), args.words_per_batch):
            chunk = words[start: start + args.words_per_batch]
            labels = encode_labels(chunk, cfg.output_max_len)
            imgs, pred_ids = run(stack, labels)
            if args.beam > 0:
                with torch.inference_mode():
                    pred_ids, _ = run.rec.beam_search(
                        imgs.permute(0, 3, 1, 2), beam_size=args.beam)
            imgs = imgs.float().cpu().numpy()
            pred_ids = pred_ids.cpu().numpy()
            all_ids.append(pred_ids)
            for i, w in enumerate(chunk):
                pred = VOCAB.decode(pred_ids[i]) or "x"
                name = os.path.join(args.out,
                                    f"{wid}-{start + i}.{w}-{pred}.png")
                _save_png(name, _normalize(imgs[i, :, :, 0]))
                files.append(name)
    seconds = time.perf_counter() - t0
    print(f"wrote {len(files)} images to {args.out} in {seconds:.3f} s "
          f"({len(files) / seconds:.1f} words/s after the models were "
          "built)")
    return {"files": files, "pred_ids": np.concatenate(all_ids),
            "seconds": seconds}


if __name__ == "__main__":
    main()
