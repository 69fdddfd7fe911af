"""One-stop folder evaluation: FID (+ per-writer WID) and generated CER:
``python -m affganwriting_torch.cli.evaluate <generated_dir> [--real <dir>]``.

The port of ``affganwriting_tpu/cli/evaluate.py`` (the reference's fid.sh,
fid_wid.sh and evaluate_cer_generated.py), with its JSON keys.  It reads
the ``.png.npy`` words that ``cli/generate_word`` writes without PIL.  The
InceptionV3 features run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("generated")
    p.add_argument("--real", default=None,
                   help="real-image dir; FID skipped if unset")
    p.add_argument("--per-writer", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from affganwriting_torch.eval.generated import cer_of_folder

    out = {"cer": cer_of_folder(args.generated)}
    if args.real:
        from affganwriting_torch.eval.fid import (
            FIDScorer,
            load_folder_images,
        )

        scorer = FIDScorer(device=args.device)
        ga, gw = load_folder_images(args.generated, args.limit)
        ra, rw = load_folder_images(args.real, args.limit)
        out["fid_provenance"] = scorer.provenance
        key = ("fid" if scorer.provenance.startswith("pretrained")
               else "fid_random_features")
        if args.per_writer:
            out[f"wid_{key}"] = scorer.fid_per_writer(
                ga, gw, ra, rw)["wid_fid"]
        else:
            out[key] = scorer.fid(ga, ra)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
