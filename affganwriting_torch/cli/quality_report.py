"""End-to-end quality report of a checkpoint:
``python -m affganwriting_torch.cli.quality_report --ckpt <dir>``.

The port of ``affganwriting_tpu/cli/quality_report.py``, the reference's
evaluation protocol (tt.test_single_writer.4_scenarios.py -> fid.sh +
evaluate_cer_generated.py) against a checkpoint of ``cli/train_word``:

1. ``cli/generate_word`` writes the scenario's words for the first
   ``--max-writers`` writers, read back by R (``<wid>-<n>.<GT>-<pred>``
   files);
2. a matched real set: per writer, ``--words-per-writer`` of its own words
   read as the dataset reads them (IAM images with ``--image-root``, else
   the synthetic renders) at the checkpoint's geometry, written through
   ``eval/sheets._save_png`` as ``<wid>-<n>.real.png`` (``.png.npy``
   without PIL);
3. the generated words' CER, and the crop-64 FID and per-writer WID
   between the two folders, from one activation pass over each;
4. ``<out>/report.json``: the JAX CLI's keys, and ``seconds`` of each of
   generation, the real set, the activations and the Fréchet distances.

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--out", default="runs/quality")
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--corpus", choices=["in_vocab", "oov"], default="oov")
    p.add_argument("--max-writers", type=int, default=8)
    p.add_argument("--words-per-writer", type=int, default=64)
    p.add_argument("--image-root", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import numpy as np

    from affganwriting_torch.cli import generate_word
    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.data.iam import (
        default_reference_paths,
        parse_groundtruth,
        writer_label_map,
    )
    from affganwriting_torch.data.words import WordStyleDataset
    from affganwriting_torch.eval.fid import (
        FIDScorer,
        crop64_preprocess,
        frechet_distance,
        gaussian_stats,
        load_folder_images,
        wid_of_activations,
    )
    from affganwriting_torch.eval.generated import cer_of_folder
    from affganwriting_torch.eval.sheets import _save_png

    # the scorer first: without a card it raises before anything is written
    scorer = FIDScorer(device=args.device)
    gen_dir = os.path.join(args.out, "generated")
    real_dir = os.path.join(args.out, "real")
    seconds = {}

    # 1. generation sweep (the gen+recognize pipeline writes GT-pred names)
    gen_argv = ["--ckpt", args.ckpt, "--ckpt-name", args.ckpt_name,
                "--out", gen_dir, "--split", args.split,
                "--corpus", args.corpus,
                "--max-writers", str(args.max_writers),
                "--words-per-batch", str(args.words_per_writer),
                "--seed", str(args.seed)]
    if args.image_root:
        gen_argv += ["--image-root", args.image_root]
    if args.device:
        gen_argv += ["--device", args.device]
    t0 = time.perf_counter()
    generate_word.main(gen_argv)
    seconds["generate"] = time.perf_counter() - t0

    # 2. matched real set: per writer, the same number of its own GT words
    # (the reference's FID real side is the IAM crops)
    t0 = time.perf_counter()
    os.makedirs(real_dir, exist_ok=True)
    cfg = CheckpointManager(args.ckpt).load_config(args.ckpt_name)
    paths = default_reference_paths()
    by_writer = parse_groundtruth(
        paths["train_gt" if args.split == "train" else "test_gt"])
    labels = writer_label_map(by_writer)
    reader_ds = WordStyleDataset(by_writer, labels, cfg,
                                 image_root=args.image_root, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for wid, entries in list(by_writer.items())[: args.max_writers]:
        pick = rng.choice(len(entries),
                          size=min(args.words_per_writer, len(entries)),
                          replace=False)
        for n, ei in enumerate(pick):
            img = reader_ds._read(entries[int(ei)], labels[wid])
            arr = ((img * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
            _save_png(os.path.join(real_dir, f"{wid}-{n}.real.png"), arr)
    seconds["real_set"] = time.perf_counter() - t0

    # 3. metrics
    report = {"scenario": f"{args.corpus}/{args.split}",
              "ckpt": f"{args.ckpt}:{args.ckpt_name}",
              "cer": cer_of_folder(gen_dir)}
    t0 = time.perf_counter()
    ga, gw = load_folder_images(gen_dir)
    ra, rw = load_folder_images(real_dir)
    act_g = scorer.activations(crop64_preprocess(ga))
    act_r = scorer.activations(crop64_preprocess(ra))
    seconds["activations"] = time.perf_counter() - t0
    # without pretrained InceptionV3 weights the score is a fixed-seed
    # random-feature distance: a relative metric, not the reference's scale
    report["fid_provenance"] = scorer.provenance
    fid_key = ("fid" if scorer.provenance.startswith("pretrained")
               else "fid_random_features")
    t0 = time.perf_counter()
    report[fid_key] = frechet_distance(*gaussian_stats(act_g),
                                       *gaussian_stats(act_r))
    try:
        report[f"wid_{fid_key}"] = wid_of_activations(
            act_g, gw, act_r, rw)["wid_fid"]
    except (ValueError, np.linalg.LinAlgError) as e:
        # a writer's sqrtm can fail on too few samples
        report["wid_fid_error"] = str(e)
    seconds["frechet"] = time.perf_counter() - t0
    report["seconds"] = seconds

    out_path = os.path.join(args.out, "report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
