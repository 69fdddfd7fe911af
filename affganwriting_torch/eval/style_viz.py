"""2D style-space visualization (the reference's umap_styles.py surface).

The port of ``affganwriting_tpu/eval/style_viz.py``: style vectors are
projected with UMAP when ``umap`` imports, otherwise onto their top two
principal directions (SVD of the centred styles), and scatter-plotted one
colour per author, written as a PNG by PIL, or as ``<path>.npy`` without
it.
"""

from __future__ import annotations

import numpy as np

from affganwriting_torch.gen.line_inference import StyleLibrary


def project_2d(styles: np.ndarray) -> np.ndarray:
    try:
        import umap  # type: ignore

        return umap.UMAP(n_components=2).fit_transform(styles)
    except Exception:
        x = styles - styles.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        return x @ vt[:2].T


def scatter_png(points: np.ndarray, labels: list, path: str,
                size: int = 512) -> str:
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    norm = (points - lo) / span
    uniq = {a: i for i, a in enumerate(dict.fromkeys(labels))}
    img = np.full((size, size, 3), 255, np.uint8)
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 200, size=(len(uniq), 3))
    for p, a in zip(norm, labels):
        y = int(p[1] * (size - 9)) + 4
        x = int(p[0] * (size - 9)) + 4
        img[y - 2:y + 3, x - 2:x + 3] = colors[uniq[a]]
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
    except ImportError:
        np.save(path + ".npy", img)
    return path


def umap_styles(library: StyleLibrary, out_path: str = "styles_2d.png"):
    pts = project_2d(library.styles)
    return scatter_png(pts, library.authors, out_path)
