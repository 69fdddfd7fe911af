"""Generate fixed words per writer and cross-check their legibility with a
teacher: ``python -m affganwriting_torch.cli.teacher_check``.

The port of ``affganwriting_tpu/cli/teacher_check.py`` (the reference's
testtrocr.py / testtrocr2.py): for each of the first ``--max-writers`` test
writers, a 50-image style stack, the ``TARGET_WORDS`` generated by G and
read by the teacher (the host HF ``TrOCRTeacher`` from ``--trocr-dir``,
else a ``SelfTeacher`` copy of R).  Writes ``<out>/results.csv`` (writer,
word, prediction, confidence) and the images (``.png``, ``.png.npy``
without PIL); ``main`` returns the rows.  The models are
``default_config()``'s, restored from ``--ckpt``'s ``best`` when given,
else random from ``--seed``.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import os

from affganwriting_torch.core.config import default_config

TARGET_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
                "dog", "hello", "world"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/teacher_check")
    p.add_argument("--trocr-dir", default=None)
    p.add_argument("--max-writers", type=int, default=2)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.eval.sheets import _normalize, _save_png
    from affganwriting_torch.gen.inference import (
        encode_labels,
        generate_images,
        resolve_device,
    )
    from affganwriting_torch.train.state import init_state
    from affganwriting_torch.train.teacher import SelfTeacher, TrOCRTeacher

    dev = resolve_device(args.device)
    cfg = default_config()
    state = init_state(cfg, dev, seed=args.seed)
    if args.ckpt:
        state = CheckpointManager(args.ckpt).restore("best", state)
    if args.trocr_dir:
        teacher = TrOCRTeacher(args.trocr_dir)
    else:
        teacher = SelfTeacher(cfg, state.rec.model)

    gt = parse_groundtruth(default_reference_paths()["test_gt"])
    label_map = writer_label_map(gt)
    ds = WordStyleDataset(gt, label_map, cfg, seed=args.seed)
    gen = state.gen.model.eval()

    os.makedirs(args.out, exist_ok=True)
    rows = []
    rng = np.random.default_rng(args.seed)
    labels = encode_labels(TARGET_WORDS, cfg.output_max_len)
    for wid in list(gt.keys())[: args.max_writers]:
        entries = list(gt[wid])
        rng.shuffle(entries)
        while len(entries) < cfg.style_stack:
            entries += entries[: cfg.style_stack - len(entries)]
        stack = np.stack(
            [ds._read(e, label_map[wid]) for e in entries[: cfg.style_stack]],
            axis=-1)[None].astype(np.float32)
        with torch.inference_mode():
            imgs = generate_images(gen, stack, labels, dev)
        texts, conf = teacher.predict(imgs)
        imgs = imgs.float().cpu().numpy()
        for i, w in enumerate(TARGET_WORDS):
            name = f"{wid}-{i}.{w}-{texts[i] or 'x'}.png"
            _save_png(os.path.join(args.out, name),
                      _normalize(imgs[i, :, :, 0]))
            rows.append((wid, w, texts[i], float(conf[i])))

    with open(os.path.join(args.out, "results.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["writer", "word", "prediction", "confidence"])
        out.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}/results.csv")
    return rows


if __name__ == "__main__":
    main()
