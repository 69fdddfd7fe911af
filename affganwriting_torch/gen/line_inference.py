"""Line-level style library and generation actions.

The port of ``affganwriting_tpu/gen/line_inference.py``: the tooling of
the reference's line_generation/get_styles.py (style extraction over a
split, pickled as {styles, authors, ids}) and generate.py's interactive
actions (interpolation sweeps, style vector math, author averages, random
styles) as functions over a ``LineGanTrainer`` and its state.  Lines come
in and go out as NHWC numpy arrays (B, H, W, 1), as in the JAX package;
the models run on the trainer's device, and ``extract_styles`` and
``generate_lines`` raise there without a card unless the trainer was
built for the CPU.  Randomness (spacing and generator noise) comes from a
``torch.Generator`` seeded from ``seed``.

``StyleLibrary`` pickles hold numpy arrays and lists only, so a library
written by either package loads in the other.
"""

from __future__ import annotations

import pickle
from typing import Iterable

import numpy as np
import torch

from affganwriting_torch.gen.inference import resolve_device
from affganwriting_torch.utils.png import encode_gray_png


class StyleLibrary:
    """{styles (N, D), authors (N,), ids (N,)} with by-author lookup,
    pickle-compatible with the reference's style files
    (get_styles.py:41-45, app.py:85-95)."""

    def __init__(self, styles: np.ndarray, authors: list, ids: list):
        self.styles = np.asarray(styles)
        self.authors = list(authors)
        self.ids = list(ids)
        self.by_author: dict = {}
        for i, a in enumerate(self.authors):
            self.by_author.setdefault(a, []).append(i)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"styles": self.styles, "authors": self.authors,
                         "ids": self.ids}, f)

    @classmethod
    def load(cls, path: str) -> "StyleLibrary":
        with open(path, "rb") as f:
            raw = pickle.load(f)
        return cls(raw["styles"], raw["authors"], raw["ids"])

    def author_average(self, author) -> np.ndarray:
        """The 'A' REPL action (generate.py)."""
        idx = self.by_author[author]
        return self.styles[idx].mean(axis=0)

    def get(self, author, index: int = 0) -> np.ndarray:
        return self.styles[self.by_author[author][index]]


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def extract_styles(trainer, state, batches: Iterable[dict]) -> StyleLibrary:
    """Run the style extractor over a dataset split (get_styles.py:19-140);
    each batch's lines are joined by ``a_batch_size``."""
    resolve_device(trainer.device)
    styles, authors, ids = [], [], []
    n = 0
    for batch in batches:
        s, _ = state.model.extract_style(trainer._put_image(batch["image"]),
                                         int(batch.get("a_batch_size", 1)))
        s = s.float().cpu().numpy()
        styles.append(s)
        authors.extend(batch["authors"])
        ids.extend(batch.get("ids", list(range(n, n + len(s)))))
        n += len(s)
    return StyleLibrary(np.concatenate(styles), authors, ids)


def interpolate(style_a: np.ndarray, style_b: np.ndarray,
                steps: int = 8) -> np.ndarray:
    """Linear interpolation sweep (generate.py 'r'/'v' actions)."""
    ts = np.linspace(0.0, 1.0, steps)[:, None]
    return (1 - ts) * style_a[None] + ts * style_b[None]


def style_math(base: np.ndarray, plus: np.ndarray, minus: np.ndarray,
               weight: float = 1.0) -> np.ndarray:
    """base + w*(plus - minus): the 'm' vector-math action."""
    return base + weight * (plus - minus)


def random_styles(library: StyleLibrary, n: int, extra: float = 0.5,
                  seed: int = 0) -> np.ndarray:
    """Random interpolations/extrapolations of library styles: the 'R'
    batch-generation action."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        i, j = rng.integers(len(library.styles), size=2)
        u = rng.uniform(-extra, 1.0 + extra)
        out.append(library.styles[i]
                   + u * (library.styles[j] - library.styles[i]))
    return np.stack(out)


def gaussian_styles(n: int, dim: int, seed: int = 0,
                    sigma: float = 1.0) -> np.ndarray:
    """The 'v' REPL action's style source (generate.py:308): N(0, sigma)
    vectors instead of extracted ones."""
    return np.random.default_rng(seed).normal(
        0.0, sigma, size=(n, dim)).astype(np.float32)


def _resample_time(onehot: np.ndarray, factor: float,
                   max_len: int) -> np.ndarray:
    """Linearly resample a spaced one-hot (B, T, K) along time by
    ``factor`` (the reference's F.interpolate(..., mode='linear'),
    generate.py:834), then pad/crop to the generator's ``max_len``, the
    trailing positions blank."""
    b, t, k = onehot.shape
    new_t = max(1, int(round(t * factor)))
    src = np.linspace(0.0, t - 1.0, new_t)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = (src - lo).astype(np.float32)
    res = (onehot[:, lo] * (1.0 - w)[None, :, None]
           + onehot[:, hi] * w[None, :, None])
    out = np.zeros((b, max_len, k), np.float32)
    n = min(max_len, new_t)
    out[:, :n] = res[:, :n]
    out[:, n:, 0] = 1.0   # trailing positions are blanks
    return out


def stretch_factors(step: float = 0.01) -> list[float]:
    """The 's' sweep schedule: 1 -> 1.1 -> 0.9 -> 1 (interpolate_horz,
    generate.py:830-852)."""
    up = list(np.arange(1.0, 1.1 + step / 2, step))
    down = list(np.arange(1.1, 0.9 - step / 2, -step))
    back = list(np.arange(0.9, 1.0 + step / 2, step))
    return [round(f, 4) for f in up + down + back]


@torch.no_grad()
def stretch_sweep(trainer, state, batch: dict, step: float = 0.02,
                  seed: int = 0) -> np.ndarray:
    """The 's' (stretch) REPL action (generate.py:278-306): the batch's
    style and DTW-spaced label, rendered along a horizontal stretch sweep
    of the spaced one-hot.  One noise seed for the whole sweep, so frames
    differ by the stretch alone.  Returns (frames, B, H, W, 1)."""
    model = state.model
    image = trainer._put_image(batch["image"])
    style, _ = model.extract_style(image)
    spaced = trainer.spaced_label(state, batch)
    onehot = np.eye(trainer.n_class, dtype=np.float32)[spaced]
    b = onehot.shape[0]
    label = torch.zeros((b, 1), dtype=torch.long, device=image.device)
    lengths = torch.ones((b,), dtype=torch.long, device=image.device)
    frames = []
    for f in stretch_factors(step):
        sp = torch.as_tensor(_resample_time(onehot, f,
                                            trainer.max_gen_length),
                             device=image.device)
        gen = torch.Generator(image.device).manual_seed(seed)
        frames.append(_nhwc(model(label, lengths, style, sp,
                                  generator=gen)[0]))
    return np.stack(frames)


@torch.no_grad()
def generate_lines(trainer, state, texts: list[str], styles: np.ndarray,
                   charset, seed: int = 0) -> np.ndarray:
    """Batched text + style -> line images (B, 64, 4 * max_gen_length, 1)
    (the generate.py / app.py path): the spacer and the generator in eval
    mode, spacing and noise from ``seed``."""
    dev = resolve_device(trainer.device)
    label_len = max(len(charset.encode(t)) for t in texts)
    labels = np.zeros((len(texts), label_len), np.int32)
    lengths = np.zeros((len(texts),), np.int32)
    for i, t in enumerate(texts):
        ids = charset.encode(t)
        labels[i, : len(ids)] = ids
        lengths[i] = len(ids)
    gen = torch.Generator(dev).manual_seed(seed)
    img, _, _ = state.model(
        torch.as_tensor(labels, dtype=torch.long, device=dev),
        torch.as_tensor(lengths, dtype=torch.long, device=dev),
        torch.as_tensor(np.asarray(styles, np.float32), device=dev),
        generator=gen)
    return _nhwc(img)


# --- writer-identification retrieval (eval_writer_id.py:15-91) -------------

def writer_retrieval(library: StyleLibrary, metric: str = "l2",
                     top_k: tuple[int, ...] = (1, 5, 20)) -> dict:
    """Leave-one-out writer retrieval from style vectors: for each style,
    rank all others by distance; success@k = same author in the top k."""
    s = library.styles
    n = len(s)
    if metric == "l1":
        d = np.sum(np.abs(s[:, None] - s[None, :]), axis=-1)
    else:
        d = np.sum((s[:, None] - s[None, :]) ** 2, axis=-1)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1)
    authors = np.asarray(library.authors)
    hits = {k: 0 for k in top_k}
    for i in range(n):
        ranked = authors[order[i]]
        for k in top_k:
            if (ranked[:k] == authors[i]).any():
                hits[k] += 1
    return {f"top{k}": hits[k] / n for k in top_k}


# --- remaining generate.py REPL actions -------------------------------------

def permute_false(sent: str, rng: np.random.Generator) -> str:
    """Word shuffle guaranteed different from the original: the 'false
    text' of the MTurk legibility pairs (generate.py:32-48)."""
    s = sent.split(" ")
    if len(s) > 4:
        m = s[1:-1]
        while m == s[1:-1]:
            rng.shuffle(m)
        s = s[:1] + m + s[-1:]
    elif len(s) > 2:
        m = list(s)
        while m == s:
            rng.shuffle(m)
        s = m
    else:
        s = s[::-1]
    return " ".join(s)


def line_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 1) in [-1, 1], ink positive -> white-background uint8
    (generate.py's (1 - img) * 127.5 convention)."""
    return np.clip((1.0 - img[..., 0]) * 127.5, 0, 255).astype(np.uint8)


def save_line_png(img: np.ndarray, path: str) -> None:
    """Write a line as an 8-bit grayscale PNG (``utils/png``)."""
    with open(path, "wb") as f:
        f.write(encode_gray_png(line_to_gray(img)))


def build_mturk_set(trainer, state, library: StyleLibrary, charset,
                    test_batches: Iterable[dict], out_dir: str, n: int,
                    interpolate_styles: bool = True, seed: int = 0) -> str:
    """The 't' REPL action (generate.py:330-470): ``n`` MTurk triples (a
    real test line, a generated line of its text, and one of a permuted
    'false' text) and text.csv describing the rows.  Returns the csv
    path."""
    import csv
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    pool: list[tuple[np.ndarray, str]] = []
    for batch in test_batches:
        texts = batch.get("texts") or [
            charset.decode(row[:le])
            for row, le in zip(np.asarray(batch["label"]),
                               np.asarray(batch["label_lengths"]))]
        for i, text in enumerate(texts):
            if text.strip():
                pool.append((batch["image"][i], text))
        if len(pool) >= n:
            break
    if not pool:
        raise ValueError("no test instances with text")

    csv_path = os.path.join(out_dir, "text.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "text", "false_text"])
        for i in range(n):
            img, text = pool[int(rng.integers(len(pool)))]
            false_text = permute_false(text, rng)
            a = library.styles[int(rng.integers(len(library.styles)))]
            if interpolate_styles:
                b = library.styles[int(rng.integers(len(library.styles)))]
                u = float(rng.random())
                style = a * u + b * (1 - u)
            else:
                style = a
            gen = generate_lines(trainer, state, [text, false_text],
                                 np.stack([style, style]), charset,
                                 seed=seed + i)
            save_line_png(np.asarray(img), os.path.join(
                out_dir, f"real_{i}.png"))
            save_line_png(gen[0], os.path.join(out_dir, f"gen_{i}.png"))
            save_line_png(gen[1], os.path.join(out_dir, f"genfalse_{i}.png"))
            w.writerow([i, text, false_text])
    return csv_path


def load_line_image(path: str, img_height: int = 64) -> np.ndarray:
    """Image file -> (H, W, 1) in the model's ink-positive [-1, 1] space
    (the 'f' action's 1 - img/128, generate.py:718-741); needs PIL."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("L"), np.float32)
    if arr.shape[0] != img_height:
        scale = img_height / arr.shape[0]
        new_w = max(1, int(round(arr.shape[1] * scale)))
        with Image.open(path) as im:
            arr = np.asarray(
                im.convert("L").resize((new_w, img_height)), np.float32)
    return (1.0 - arr / 128.0)[..., None]


@torch.no_grad()
def style_transfer_images(trainer, state, path_a: str, path_b: str,
                          text: str, charset, steps: int = 8,
                          img_height: int = 64, seed: int = 0) -> np.ndarray:
    """The 'f' REPL action (generate.py:712-793): the styles of two
    reference images, ``text`` rendered at ``steps`` points from A to B.
    Returns (steps, H, W, 1)."""
    img_a = load_line_image(path_a, img_height)
    img_b = load_line_image(path_b, img_height)
    min_w = min(img_a.shape[1], img_b.shape[1])
    pair = np.stack([img_a[:, :min_w], img_b[:, :min_w]])[..., :1]
    styles, _ = state.model.extract_style(trainer._put_image(pair), 1)
    styles = styles.float().cpu().numpy()
    sweep = interpolate(styles[0], styles[1], steps)
    return generate_lines(trainer, state, [text] * steps, sweep, charset,
                          seed=seed)


def umap_image_sheet(library: StyleLibrary, images: np.ndarray,
                     out_path: str, sheet: int = 2048,
                     thumb_h: int = 32) -> str:
    """The 'u' REPL action (generate.py umap-images): line thumbnails at
    their style vectors' 2D projection (``eval/style_viz.project_2d``);
    needs PIL for the thumbnails."""
    from PIL import Image

    from affganwriting_torch.eval.style_viz import project_2d

    pts = project_2d(library.styles)
    pts = pts - pts.min(0)
    pts = pts / np.maximum(pts.max(0), 1e-6)

    canvas = np.full((sheet, sheet), 255, np.uint8)
    for i, img in enumerate(images):
        arr = line_to_gray(img)
        h, w = arr.shape
        tw = max(1, int(w * thumb_h / h))
        thumb = np.asarray(Image.fromarray(arr).resize((tw, thumb_h)))
        y = int(pts[i, 1] * (sheet - thumb_h))
        x = int(pts[i, 0] * (sheet - tw)) if tw < sheet else 0
        canvas[y: y + thumb_h, x: x + min(tw, sheet)] = np.minimum(
            canvas[y: y + thumb_h, x: x + min(tw, sheet)],
            thumb[:, : min(tw, sheet)])
    Image.fromarray(canvas).save(out_path)
    return out_path
