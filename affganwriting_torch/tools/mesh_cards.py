"""The port's mesh over NCCL on every card of one host, one process a card.

    python3 -m affganwriting_torch.tools.mesh_cards

Needs two cards or more (``chip_smoke.py`` phase 14 covers one card: NCCL
at world 1, and two ranks sharing it over gloo).  ``default_config()``
with random weights from seed 0:

1. serving: ``make_sharded_pipeline`` with 1 writer x 256 words over
   'data' = all N cards (256 / N words a card), spawned ranks over NCCL;
   each rank's first call captures the decoder's CUDA graph (a warm-up and
   the capture: ``in_relu`` 4 times and ``phase_head`` twice), holds
   the gathered images within 2^-6 x max(1, |ref|) (``chip_smoke.py``'s
   ``bf16_tolerance_ok``) and the greedy ids within 2% of the unsharded
   calls on each card's words, reports their distance from the unsharded
   call on the whole request (bf16 sums taken at batch 256 / N, not 256),
   and times its call (the gather included) and its share alone with CUDA
   events; rank 0 also times the unsharded call on one card;
2. training under ``python -m torch.distributed.run --nproc-per-node N``:
   ``train_word --mesh (N/2)x2`` for one epoch of 8 writers at batch 8
   (bf16, Adam), its metrics finite and its checkpoints written once;
   then ``generate_word --mesh N`` from that checkpoint against ``--mesh
   none``: the same files (their names carry R's reading); the pixels'
   largest difference is reported (bf16 sums at another batch size move
   a pixel by a few of 255 levels) and held under 16, which a word in the
   wrong style or of the wrong text would pass by far.

Prints one JSON line a part, and returns them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SEED = 0
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"] * 32


def _event_ms(fn, reps: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def serve_rank(rank: int, world: int, init: str) -> None:
    """One rank of part 1; prints ``MESH_CARDS {json}``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_sharded_pipeline,
    )
    from affganwriting_torch.ops.in_relu_cuda import in_relu
    from affganwriting_torch.ops.phase_head_cuda import phase_head
    from affganwriting_torch.parallel.mesh import make_mesh
    from affganwriting_torch.parallel.multihost import init_distributed

    init_distributed("nccl", init_method=init, rank=rank, world_size=world)
    mesh = make_mesh(world, 1)
    cfg = default_config()
    run = make_sharded_pipeline(cfg, mesh, seed=SEED)
    style = np.random.default_rng(SEED).normal(size=(
        1, cfg.img_height, cfg.img_width, cfg.style_stack)).astype(np.float32)
    labels = encode_labels(WORDS, cfg.output_max_len)
    in_relu.launches = phase_head.launches_wgmma = 0
    images, ids = run(style, labels)
    torch.cuda.synchronize()
    launches = (in_relu.launches, phase_head.launches_wgmma)
    k = len(WORDS) // world
    chunks = [run.base(style, labels[i * k:(i + 1) * k]) for i in range(world)]
    ref_img = torch.cat([c[0] for c in chunks])
    ref_ids = torch.cat([c[1] for c in chunks])
    d = (images.float() - ref_img.float()).abs()
    ok = bool((d <= ref_img.float().abs().clamp_min(1.0) * 2.0 ** -6).all())
    flips = float((ids != ref_ids).float().mean())
    whole_img, whole_ids = run.base(style, labels)
    placed = (run.place(style), run.shard_labels(labels))
    out = {"rank": rank, "cards": world, "words": len(WORDS),
           "launches": launches, "max_abs_err": float(d.max()),
           "bit_equal": bool(torch.equal(images, ref_img)
                             and torch.equal(ids, ref_ids)),
           "token_flips": flips,
           "max_abs_err_whole_request": float(
               (images.float() - whole_img.float()).abs().max()),
           "token_flips_whole_request": float(
               (ids != whole_ids).float().mean()),
           "call_ms": _event_ms(lambda: run(style, labels)),
           "share_ms": _event_ms(lambda: run.local(*placed))}
    dist.barrier()
    if rank == 0:      # the unsharded call on this card alone
        out["one_card_ms"] = _event_ms(lambda: run.base(style, labels))
    print("MESH_CARDS " + json.dumps(out), flush=True)
    # the first call captures the decoder's graph: a warm-up and the
    # capture, each launching in_relu twice and phase_head once
    if launches != (4, 2) or not ok or flips > 0.02:
        raise AssertionError(f"rank {rank}: {out}")
    dist.barrier()
    dist.destroy_process_group()


def _run(argv: list, env: dict) -> str:
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(argv[:6])} ...: {proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def _image(path: Path):
    import numpy as np

    if path.suffix == ".npy":
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


def train_and_generate(world: int, tmp: str) -> dict:
    """Part 2, through the CLIs under the launcher."""
    import math

    import numpy as np

    env = {**os.environ, "PYTHONHASHSEED": "0"}
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", str(world), "-m"]
    logdir = Path(tmp, "word")
    mesh = f"{world // 2}x2"
    _run(launch + ["affganwriting_torch.cli.train_word", "--mesh", mesh,
                   "--epochs", "1", "--max-writers", "8", "--batch-size",
                   "8", "--restart-rss-gb", "0", "--logdir", str(logdir)],
         env)
    lines = [json.loads(x) for x in open(logdir / "metrics.jsonl")]
    bad = [(r["group"], k) for r in lines for k, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)]
    files = sorted(os.listdir(logdir / "ckpt"))
    if bad or [r["group"] for r in lines] != ["train", "eval"] \
            or "latest" not in files:
        raise AssertionError(f"train_word --mesh {mesh}: {lines} {files}")
    common = ["affganwriting_torch.cli.generate_word", "--ckpt",
              str(logdir / "ckpt"), "--ckpt-name", "latest", "--corpus",
              "ladder", "--max-writers", "1"]
    _run(launch + common + ["--mesh", str(world), "--out", f"{tmp}/mesh"],
         env)
    _run([sys.executable, "-m"] + common + ["--out", f"{tmp}/one"], env)
    names = sorted(os.listdir(f"{tmp}/one"))
    if not names or sorted(os.listdir(f"{tmp}/mesh")) != names:
        raise AssertionError("generate_word --mesh: other files")
    worst = max(int(np.abs(_image(Path(tmp, "mesh", n)).astype(int)
                           - _image(Path(tmp, "one", n)).astype(int)).max())
                for n in names)
    if worst >= 16:
        raise AssertionError(f"generate_word --mesh: pixels off by {worst}")
    return {"train_word_mesh": mesh, "epoch": lines[0],
            "ckpt_files": files, "generate_files": len(names),
            "generate_max_pixel_diff": worst}


def main(argv=None) -> list[dict]:
    import torch

    from affganwriting_torch.ops import cuda_build
    from affganwriting_torch.parallel.multihost import spawn
    from affganwriting_torch.tools.timing import nvidia_smi_line

    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"mesh_cards needs two cards or more; {world} here")
    card = nvidia_smi_line()
    print(f"{world} cards; the first: {card}", flush=True)
    cuda_build.build()
    outs = spawn("affganwriting_torch.tools.mesh_cards:serve_rank", world,
                 timeout_s=900)
    rows = [json.loads(next(x for x in o.splitlines()
                            if x.startswith("MESH_CARDS "))[11:])
            for o in outs]
    for r in rows:
        r["card"] = card
        print(json.dumps(r), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli = {**train_and_generate(world, tmp), "card": card}
    print(json.dumps(cli), flush=True)
    return rows + [cli]


if __name__ == "__main__":
    main()
