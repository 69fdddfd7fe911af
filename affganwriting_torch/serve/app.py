"""Web app: styled line generation (``streamlit run .../serve/app.py``).

The port of ``affganwriting_tpu/serve/app.py`` (the reference's
line_generation/app.py:32-421): load a ``train_line`` checkpoint directory
(or random weights from a seed), a style library and the charset; pick a
style from the library (author, index); type text; generate; download the
PNG.  The backend is ``gen/line_inference.generate_lines`` on the card
(``--device cpu`` for the CPU).

The Emuru backend (``serve/emuru.py``) shows only where a local snapshot
exists; nothing is downloaded.  Streamlit is optional and imported only by
``run_streamlit``: ``python -m affganwriting_torch.serve.app --selftest
[--ckpt DIR]`` drives the whole generation path headlessly.  PNGs are
written with the standard library (``utils/png``): the app needs PIL for
the Emuru backend alone.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from affganwriting_torch.utils.png import encode_gray_png


def _load_backend(ckpt_dir=None, styles_path=None, seed=0,
                  max_gen_length=128, width=256, n_authors=None,
                  device=None):
    """(trainer, state, style library, charset): a checkpoint directory of
    ``LineCheckpointManager`` (``best`` when there is one, else
    ``latest``), or random weights from ``seed``; the library from
    ``styles_path``, else extracted from synthetic lines."""
    from affganwriting_torch.data.lines import LineCharset, LineDataset
    from affganwriting_torch.gen.inference import resolve_device
    from affganwriting_torch.gen.line_inference import (
        StyleLibrary,
        extract_styles,
    )
    from affganwriting_torch.train.line_trainer import LineGanTrainer

    resolve_device(device)
    charset = LineCharset()
    authors = [f"a{i:03d}" for i in range(n_authors)] if n_authors else None
    ds = LineDataset(charset, authors=authors, a_batch_size=1, width=width,
                     label_len=24)
    first = next(ds.batches(batch_authors=2))
    if ckpt_dir:
        if not os.path.exists(os.path.join(ckpt_dir, "latest.config.json")):
            raise FileNotFoundError(
                f"{ckpt_dir} is not a train_line checkpoint directory (no "
                "latest.config.json)")
        from affganwriting_torch.core.checkpoint import restore_line_trainer

        name = "best" if os.path.exists(
            os.path.join(ckpt_dir, "best")) else "latest"
        trainer, payload = restore_line_trainer(ckpt_dir, first, name,
                                                device=device)
        state = payload["state"]
    else:
        trainer = LineGanTrainer(n_class=charset.n_class,
                                 max_gen_length=max_gen_length, seed=seed,
                                 device=device)
        state = trainer.init_state(first)
    if styles_path and os.path.exists(styles_path):
        library = StyleLibrary.load(styles_path)
    else:
        library = extract_styles(trainer, state, ds.batches(batch_authors=2))
    return trainer, state, library, charset


def _to_png(img: np.ndarray) -> np.ndarray:
    """(H, W, 1) in [-1, 1], ink positive -> the app's uint8 page."""
    arr = ((img[..., 0] * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
    return 255 - arr


def _to_png_bytes(img: np.ndarray) -> bytes:
    return encode_gray_png(_to_png(img))


def _maybe_emuru():
    """Local Emuru snapshot path, or None (serve/emuru.py discovery)."""
    try:
        from affganwriting_torch.serve.emuru import find_local_snapshot

        return find_local_snapshot()
    except Exception:
        return None


def run_streamlit(device=None):
    import streamlit as st

    from affganwriting_torch.gen.line_inference import (
        generate_lines,
        interpolate,
    )

    st.title("Handwriting line generation")
    ckpt = st.sidebar.text_input("Checkpoint dir", "")
    styles = st.sidebar.text_input("Style library (.pkl)", "")

    @st.cache_resource
    def backend(ckpt, styles):
        return _load_backend(ckpt or None, styles or None, device=device)

    trainer, state, library, charset = backend(ckpt, styles)

    authors = sorted(library.by_author)
    author = st.selectbox("Author", authors)
    index = st.number_input(
        "Sample", 0, max(0, len(library.by_author[author]) - 1), 0)
    text = st.text_input("Text", "The quick brown fox")
    seed = st.number_input("Seed", 0, 10_000, 0)
    if st.button("Generate"):
        style = library.get(author, int(index))
        img = generate_lines(trainer, state, [text], style[None], charset,
                             seed=int(seed))
        st.image(_to_png_bytes(img[0]))
        st.download_button("Download PNG", _to_png_bytes(img[0]),
                           file_name="generated.png")
    if st.button("Interpolation sweep") and len(authors) >= 2:
        a = library.author_average(authors[0])
        b = library.author_average(authors[-1])
        imgs = generate_lines(trainer, state, [text] * 6,
                              interpolate(a, b, steps=6), charset,
                              seed=int(seed))
        for im in imgs:
            st.image(_to_png_bytes(im))
    snapshot = _maybe_emuru()
    if snapshot:
        import io

        from PIL import Image

        from affganwriting_torch.serve.emuru import generate_emuru

        st.header("Emuru backend")
        st.caption(f"snapshot: {snapshot}")
        up = st.file_uploader("Style image (a handwriting line)",
                              type=("png", "jpg", "jpeg"))
        style_text = st.text_input("Style image transcription", "")
        gen_text = st.text_input("Emuru text", "The quick brown fox")
        if st.button("Generate (Emuru)") and up is not None:
            out = generate_emuru(Image.open(up), style_text, gen_text)
            buf = io.BytesIO()
            out.save(buf, format="PNG")
            st.image(buf.getvalue())
            st.download_button("Download PNG", buf.getvalue(),
                               file_name="emuru.png")


def selftest(ckpt_dir=None, device=None) -> dict:
    """Generate "Hello world" in a library style headlessly, encode it as
    PNG and report the Emuru backend's status; returns the image, the PNG
    bytes and that status."""
    from affganwriting_torch.gen.line_inference import generate_lines
    from affganwriting_torch.serve import emuru

    trainer, state, library, charset = _load_backend(
        ckpt_dir, max_gen_length=48, width=128, n_authors=4, device=device)
    author = sorted(library.by_author)[0]
    img = generate_lines(trainer, state, ["Hello world"],
                         library.get(author)[None], charset, seed=0)
    png = _to_png_bytes(img[0])
    if emuru.available():
        emuru_status = f"available ({emuru.find_local_snapshot()})"
    else:
        try:
            emuru.load_emuru()
            raise AssertionError("load_emuru must raise without a snapshot")
        except FileNotFoundError as e:
            emuru_status = f"absent, raises cleanly ({e})"
    print(f"selftest ok: image {img.shape}, png {len(png)} bytes, "
          f"{len(library.styles)} styles from {len(library.by_author)} "
          f"authors; emuru: {emuru_status}")
    return {"image": img, "png": png, "page": _to_png(img[0]),
            "styles": len(library.styles), "emuru": emuru_status}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--ckpt", default=None,
                   help="train_line checkpoint directory (<logdir>/ckpt); "
                        "random weights if unset")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    if args.selftest:
        return selftest(args.ckpt, args.device)
    return run_streamlit(args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
