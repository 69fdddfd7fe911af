"""Sub-stage profiling of the generator half of the pipeline on the card:
``python -m affganwriting_torch.cli.profile_gen --batch 2048``.

The port of ``affganwriting_tpu/cli/profile_gen.py``: the ``generate``
stage of ``cli/profile_pipeline.py`` split into its phases, each timed
streaming (``utils/profiling.stream_ms``) with its FLOPs and no-fusion
bytes counted on one more call (``utils/profiling.op_counts``, the CUDA
kernels' reports included), against the card's peaks (as
``profile_pipeline``; null on a ``--device cpu`` run):

  text_mix   labels -> (mixed, adain_params) (TextEncoderFC + SplitMix;
             the only per-word work before the decoder)
  res        the decoder's two AdaIN ResBlocks (``res0``, ``res1``) at
             (512, 8, 27), the two iAFF skip fusions included
  res_plain  the same blocks with the skips set to None (iAFF cost = res -
             res_plain)
  upchain    (512, 8, 27) -> (1, 64, 216): ``Decoder.up_chain``, the three
             subpixel upsample convs (``up0..2``), their instance norms
             and the phase head (``head``)

Each stage calls the submodules of the generator that ``default_config()``
builds (random weights, eval mode), not a replica of them.  So where the
JAX CLI's ``UpChain`` wrapper runs plain ``instance_norm`` and the
non-Pallas head, the port's ``upchain`` runs the main path's kernels: on
the card one call launches ``in_relu.cu`` twice and ``phase_head.cu``
once.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

from affganwriting_torch.core.config import default_config


def main(argv=None):
    """Profile; returns the printed rows."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--n-stream", type=int, default=30)
    p.add_argument("--stages", default=None)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from affganwriting_torch.gen.inference import (
        build_generator,
        encode_labels,
        resolve_device,
    )
    from affganwriting_torch.models.decoder import split_adain_params
    from affganwriting_torch.utils.profiling import (
        device_peaks,
        op_counts,
        stage_row,
        stream_ms,
    )

    dev = resolve_device(args.device)
    card, peaks = device_peaks(dev)
    cfg = default_config()
    gen = build_generator(cfg, dev, seed=0)
    dec = gen.dec
    b = args.batch
    rng = np.random.default_rng(0)
    style = torch.as_tensor(rng.normal(size=(
        1, cfg.img_height, cfg.img_width, cfg.style_stack)).astype(
            np.float32), device=dev)
    words = ["profile", "generator", "substage", "timing"] * (b // 4 + 1)
    labels = torch.as_tensor(encode_labels(words[:b], cfg.output_max_len),
                             device=dev).long()

    def text_mix(lab, f_xs):
        ap, content = gen.text_encoder(lab, f_xs.shape[2:])
        return gen.linear_mix(f_xs, content), ap

    def res(mixed, ap, skip1, skip3):
        sites = split_adain_params(ap, 4, dec.dim)
        x = dec.res0(mixed, sites[0], sites[1], skip1)
        return dec.res1(x, sites[2], sites[3], skip3)

    rows = []
    only = set(args.stages.split(",")) if args.stages else None
    with torch.inference_mode():
        pyramid = gen.encode_style(style)
        skip1 = F.max_pool2d(pyramid[3], 2, 2)
        skip3 = pyramid[4]
        mixed, ap = text_mix(labels, pyramid[-1])
        x_res = res(mixed, ap, skip1, skip3)
        stages = {
            "text_mix": (text_mix, (labels, pyramid[-1]),
                         (labels.roll(1, 0), pyramid[-1])),
            "res": (res, (mixed, ap, skip1, skip3),
                    (mixed + 0.01, ap + 0.01, skip1, skip3)),
            "res_plain": (res, (mixed, ap, None, None),
                          (mixed + 0.01, ap + 0.01, None, None)),
            "upchain": (dec.up_chain, (x_res,), (x_res + 0.01,)),
        }
        for name, (fn, a, bb) in stages.items():
            if only and name not in only:
                continue
            ms = stream_ms(fn, a, bb, args.n_stream, dev)
            counts = op_counts(fn, *a)
            row = stage_row(name, ms, counts, peaks, batch=b,
                            imgs_per_sec=round(b / (ms / 1e3), 1))
            row["device"] = card
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
