"""Emit per-writer generation job scripts.

The port of ``affganwriting_tpu/cli/emit_jobs.py`` (the reference's
``GAN_word/get_sh_command.py``, a shell script of per-writer
``tt.test_single_writer`` invocations for a cluster to fan out): each job
line calls the port's ``cli.generate_word`` with an explicit ``--writers``
filter; ``--shard N`` splits the writer list into N scripts for N hosts,
each of which batches its writers on its card.  ``main`` returns the
scripts' paths.

    python -m affganwriting_torch.cli.emit_jobs --ckpt runs/x/ckpt \
        --split test --shard 4 --out jobs/
"""

from __future__ import annotations

import argparse
import os
import stat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--corpus", choices=["in_vocab", "oov"], default="oov")
    p.add_argument("--out", default="jobs")
    p.add_argument("--gen-out", default="runs/generated")
    p.add_argument("--shard", type=int, default=1)
    p.add_argument("--writers-per-job", type=int, default=8)
    args = p.parse_args(argv)

    from affganwriting_torch.data.iam import (
        default_reference_paths,
        parse_groundtruth,
    )

    paths = default_reference_paths()
    gt = parse_groundtruth(
        paths["train_gt" if args.split == "train" else "test_gt"])
    writers = list(gt.keys())

    os.makedirs(args.out, exist_ok=True)
    shards: list[list[str]] = [[] for _ in range(args.shard)]
    for start in range(0, len(writers), args.writers_per_job):
        chunk = writers[start: start + args.writers_per_job]
        cmd = (
            "python -m affganwriting_torch.cli.generate_word"
            f" --ckpt {args.ckpt} --ckpt-name {args.ckpt_name}"
            f" --split {args.split} --corpus {args.corpus}"
            f" --out {args.gen_out}"
            f" --writers {' '.join(chunk)}"
        )
        shards[(start // args.writers_per_job) % args.shard].append(cmd)

    scripts = []
    for i, cmds in enumerate(shards):
        path = os.path.join(args.out, f"generate_shard{i:02d}.sh")
        with open(path, "w") as f:
            f.write("#!/bin/sh\nset -e\n")
            f.write("\n".join(cmds) + "\n")
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        scripts.append(path)
        print(f"{path}: {len(cmds)} jobs")
    return scripts


if __name__ == "__main__":
    main()
