"""Inspect a checkpoint of the port: its config, step and per-player
parameter counts (the reference's seemodel.py).

    python -m affganwriting_torch.cli.inspect_ckpt <ckpt_dir> [--name latest]

The port of ``affganwriting_tpu/cli/inspect_ckpt.py``; the counts are
``train/state.py:param_count``'s.  The checkpoint is loaded into a state on
the card unless ``--device cpu``.  ``main`` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt_dir")
    p.add_argument("--name", default="latest")
    p.add_argument("--shapes", action="store_true",
                   help="print every parameter's shape")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to load on the CPU")
    args = p.parse_args(argv)

    from affganwriting_torch.core.checkpoint import CheckpointManager
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.train.state import (
        PLAYERS,
        init_state,
        param_count,
    )

    dev = resolve_device(args.device)
    ck = CheckpointManager(args.ckpt_dir)
    config = ck.load_config(args.name)
    print(config.to_json())
    state = ck.restore(args.name, init_state(config, dev))
    out = {"step": state.step, "param_counts": param_count(state)}
    print(json.dumps(out, indent=2))
    if args.shapes:
        for player in PLAYERS:
            for name, t in getattr(state, player).model.named_parameters():
                print(f"{player}/{name}: {tuple(t.shape)} {t.dtype}")
    return out


if __name__ == "__main__":
    main()
