"""Interactive line-generation REPL, the reference's ``generate.py`` UX:
``python -m affganwriting_torch.cli.line_repl --ckpt runs/line_gan/ckpt``.

The port of ``affganwriting_tpu/cli/line_repl.py`` (line_generation/
generate.py:257-793's prompt loop) over the port's library actions
(``gen/line_inference.py``).  Each action maps 1:1:

    a  show author ids                r  random style interpolation sweep
    m  style vector math              A  author-average style
    R  random-style batch             t  MTurk set builder
    f  image-pair style transfer      u  UMAP image sheet
    s  horizontal stretch sweep       v  Gaussian (VAE) style interpolation
    h  this help                      q  quit

Non-interactive use: ``--script "r;q"`` feeds the prompt (newline/;
split), which is how the selftest exercises every action headlessly.
Where the JAX REPL passes ``jax.random.key(seed)``, the port passes the
seed.  The JAX CLI's flags and ``--device`` (default the card; ``cpu``
runs on the CPU).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=None,
                   help="line-trainer checkpoint dir (the run's ckpt/ "
                        "directory); restores the trained model the way "
                        "the reference's generate.py -c does")
    p.add_argument("--ckpt-name", default="latest",
                   choices=("latest", "best"),
                   help="which checkpoint in the dir to restore")
    p.add_argument("--styles", default=None, help="style-library pickle")
    p.add_argument("--out", default="runs/line_repl")
    p.add_argument("--script", default=None,
                   help="pre-baked inputs, ';'-separated (headless)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    import itertools

    import numpy as np

    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.gen import line_inference as li
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    charset = LineCharset()
    ds = LineDataset(charset, a_batch_size=2, width=256, label_len=24,
                     seed=args.seed)
    batches = list(itertools.islice(ds.batches(batch_authors=1), 2))
    if args.ckpt:
        # restore the trained model + config from the run's checkpoint
        # (reference generate.py:88-97: the checkpoint's embedded config
        # rebuilds the exact arch, then state_dict loads into it)
        from affganwriting_torch.core.checkpoint import restore_line_trainer

        trainer, payload = restore_line_trainer(
            args.ckpt, batches[0], name=args.ckpt_name, device=args.device)
        state = payload["state"]
        print(f"restored {args.ckpt_name} checkpoint "
              f"(iteration {int(payload['iteration'])})")
    else:
        trainer = LineGanTrainer(n_class=charset.n_class, max_gen_length=64,
                                 seed=args.seed, device=args.device)
        state = trainer.init_state(batches[0])
    if args.styles and os.path.exists(args.styles):
        library = li.StyleLibrary.load(args.styles)
    else:
        library = li.extract_styles(trainer, state, iter(batches))

    feed = iter(args.script.replace(";", "\n").split("\n")) if args.script \
        else None

    def ask(prompt):
        if feed is not None:
            try:
                v = next(feed).strip()
            except StopIteration:
                return "q"
            print(f"{prompt}{v}")
            return v
        return input(prompt)

    while True:
        c = ask("a/r/s/v/m/A/R/t/f/u/q? ")
        if not c or c[0] in "qed":
            break
        c = c[0]
        if c == "a":
            print(sorted(set(library.authors)))
        elif c == "s":
            # strech sweep (reference generate.py:278-306, interpolate_horz
            # :830-852): stretch the DTW-spaced label of a batch
            idx = int(ask("batch? ") or "0") % len(batches)
            frames = li.stretch_sweep(trainer, state, batches[idx],
                                      step=0.02, seed=args.seed)
            for b in range(frames.shape[1]):
                for k in range(frames.shape[0]):
                    li.save_line_png(frames[k, b], os.path.join(
                        args.out, f"gen{b}_{k}.png"))
            print(f"wrote {frames.shape[0]} stretch frames x "
                  f"{frames.shape[1]} lines to {args.out}")
        elif c == "v":
            # Gaussian (VAE) random styles, interpolated like 'r'
            n = int(ask("steps? ") or "4")
            text = ask("text? ") or "hello world"
            g = li.gaussian_styles(2, library.styles.shape[1],
                                   seed=args.seed)
            sweep = li.interpolate(g[0], g[1], n)
            imgs = li.generate_lines(trainer, state, [text] * n, sweep,
                                     charset)
            for k, img in enumerate(imgs):
                li.save_line_png(img, os.path.join(args.out, f"vae{k}.png"))
            print(f"wrote {n} gaussian-style frames to {args.out}")
        elif c == "r":
            n = int(ask("steps? ") or "4")
            text = ask("text? ") or "hello world"
            i, j = np.random.default_rng(args.seed).integers(
                len(library.styles), size=2)
            sweep = li.interpolate(library.styles[int(i)],
                                   library.styles[int(j)], n)
            imgs = li.generate_lines(trainer, state, [text] * n, sweep,
                                     charset)
            for k, img in enumerate(imgs):
                li.save_line_png(img, os.path.join(args.out, f"interp{k}.png"))
            print(f"wrote {n} interpolation frames to {args.out}")
        elif c == "m":
            a = ask("base author? ") or library.authors[0]
            plus = ask("+ author? ") or library.authors[-1]
            minus = ask("- author? ") or library.authors[0]
            s = li.style_math(library.author_average(a),
                              library.author_average(plus),
                              library.author_average(minus))
            img = li.generate_lines(trainer, state, ["style math"], s[None],
                                    charset)
            li.save_line_png(img[0], os.path.join(args.out, "math.png"))
            print("wrote math.png")
        elif c == "A":
            a = ask("author? ") or library.authors[0]
            img = li.generate_lines(
                trainer, state, [f"average of {a}"],
                library.author_average(a)[None], charset)
            li.save_line_png(img[0], os.path.join(args.out, "average.png"))
            print("wrote average.png")
        elif c == "R":
            n = int(ask("how many? ") or "4")
            text = ask("text (empty = random)? ")
            styles = li.random_styles(library, n, seed=args.seed)
            if not text:
                from affganwriting_torch.data.wiki_text import WikiText

                wiki = WikiText()
                texts = [wiki[k] for k in range(n)]
            else:
                texts = [text] * n
            imgs = li.generate_lines(trainer, state, texts, styles, charset)
            for k, img in enumerate(imgs):
                li.save_line_png(img, os.path.join(args.out, f"rand{k}.png"))
            print(f"wrote {n} random-style lines")
        elif c == "t":
            n = int(ask("number of instances? ") or "2")
            csv_path = li.build_mturk_set(
                trainer, state, library, charset, iter(batches),
                os.path.join(args.out, "mturk"), n, seed=args.seed)
            print(f"wrote {csv_path}")
        elif c == "f":
            p1 = ask("image path 1? ")
            p2 = ask("image path 2? ")
            text = ask("text? ") or "transfer"
            if not (p1 and p2 and os.path.exists(p1) and os.path.exists(p2)):
                print("need two existing image paths")
                continue
            imgs = li.style_transfer_images(trainer, state, p1, p2, text,
                                            charset, steps=4)
            for k, img in enumerate(imgs):
                li.save_line_png(
                    img, os.path.join(args.out, f"transfer{k}.png"))
            print("wrote 4 transfer frames")
        elif c == "u":
            imgs = li.generate_lines(
                trainer, state,
                ["sheet"] * len(library.styles),
                library.styles, charset)
            out = li.umap_image_sheet(
                library, imgs, os.path.join(args.out, "umap_sheet.png"))
            print(f"wrote {out}")
        elif c == "h":
            print(__doc__)
    print("bye")


if __name__ == "__main__":
    main()
