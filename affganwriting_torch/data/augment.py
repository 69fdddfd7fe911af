"""Host-side image augmentation for HTR training.

The port's own numpy copy of ``affganwriting_tpu/data/augment.py`` (that
package's ``__init__`` imports jax), the reference's augmentors: the
"marcal" pipeline (GAN_word/recognizer/marcal_augmentor_v4 over
doc_augment_lib: blur/sharpen -> elastic(alpha=1750, sigma=45) -> shear ->
rotation -> gamma -> random background) and the line pipeline's grid warp
(line_generation/utils/grid_distortion.py).  Each op is keyed by a numpy
``Generator``, so the same seed reproduces the same augmentation, bit for
bit the JAX package's.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img
    radius = max(1, int(3 * sigma))
    k = _gaussian_kernel1d(sigma, radius)
    out = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, radius, mode="edge"), k,
                              mode="valid"), 0, img)
    out = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, radius, mode="edge"), k,
                              mode="valid"), 1, out)
    return out.astype(img.dtype)


def sharpen(img: np.ndarray, amount: float = 1.0) -> np.ndarray:
    blurred = gaussian_blur(img, 1.0)
    return np.clip(img + amount * (img - blurred), img.min(), img.max())


def _sample_bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                     fill: float = 0.0) -> np.ndarray:
    h, w = img.shape
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    wy = ys - y0
    wx = xs - x0
    out = np.zeros_like(ys, dtype=np.float32)
    total_w = np.zeros_like(ys, dtype=np.float32)
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            yy = y0 + dy
            xx = x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = np.where(valid, img[np.clip(yy, 0, h - 1),
                                    np.clip(xx, 0, w - 1)], fill)
            out += wgt_y * wgt_x * v
            total_w += wgt_y * wgt_x
    return out


def elastic(img: np.ndarray, rng: np.random.Generator,
            alpha: float = 1750.0, sigma: float = 45.0) -> np.ndarray:
    """Gaussian-smoothed random displacement field (marcal defaults)."""
    h, w = img.shape
    dx = gaussian_blur(
        rng.uniform(-1, 1, size=(h, w)).astype(np.float32), sigma) * alpha
    dy = gaussian_blur(
        rng.uniform(-1, 1, size=(h, w)).astype(np.float32), sigma) * alpha
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return _sample_bilinear(img, ys + dy, xs + dx, fill=float(img.min()))


def shear(img: np.ndarray, factor: float) -> np.ndarray:
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return _sample_bilinear(img, ys, xs - factor * (ys - h / 2),
                            fill=float(img.min()))


def rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    h, w = img.shape
    th = np.deg2rad(degrees)
    cy, cx = h / 2, w / 2
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    y = ys - cy
    x = xs - cx
    src_y = np.cos(th) * y - np.sin(th) * x + cy
    src_x = np.sin(th) * y + np.cos(th) * x + cx
    return _sample_bilinear(img, src_y, src_x, fill=float(img.min()))


def gamma_adjust(img01: np.ndarray, gamma: float) -> np.ndarray:
    return np.clip(img01, 0.0, 1.0) ** gamma


def random_background(img01: np.ndarray, rng: np.random.Generator,
                      strength: float = 0.1) -> np.ndarray:
    noise = gaussian_blur(
        rng.uniform(0, 1, img01.shape).astype(np.float32), 8.0)
    return np.clip(img01 + strength * noise, 0.0, 1.0)


def grid_warp(img: np.ndarray, rng: np.random.Generator,
              grid: int = 4, mag: float = 2.0) -> np.ndarray:
    """Coarse-grid random warp (utils/grid_distortion.py)."""
    h, w = img.shape
    gy = np.linspace(0, h - 1, grid)
    gx = np.linspace(0, w - 1, grid)
    dy = rng.uniform(-mag, mag, (grid, grid)).astype(np.float32)
    dx = rng.uniform(-mag, mag, (grid, grid)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def upsample(field):
        # bilinear upsample of the grid field to full res
        fy = np.interp(np.arange(h), gy, np.arange(grid))
        fx = np.interp(np.arange(w), gx, np.arange(grid))
        y0 = np.clip(np.floor(fy).astype(int), 0, grid - 2)
        x0 = np.clip(np.floor(fx).astype(int), 0, grid - 2)
        wy = (fy - y0)[:, None]
        wx = (fx - x0)[None, :]
        a = field[np.ix_(y0, x0)]
        b = field[np.ix_(y0, x0 + 1)]
        c = field[np.ix_(y0 + 1, x0)]
        d = field[np.ix_(y0 + 1, x0 + 1)]
        return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
                + c * wy * (1 - wx) + d * wy * wx)

    return _sample_bilinear(img, ys + upsample(dy), xs + upsample(dx),
                            fill=float(img.min()))


def marcal_augment(img01: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The full marcal pipeline on a [0, 1] ink-on-white image
    (GAN_word/recognizer/marcal_augmentor_v4/marcal_augmentor_v4.py:8-35)."""
    img = img01.astype(np.float32)
    if rng.random() < 0.5:
        img = gaussian_blur(img, float(rng.uniform(0.5, 1.5)))
    else:
        img = sharpen(img, float(rng.uniform(0.5, 1.5)))
    img = elastic(img, rng)
    img = shear(img, float(rng.uniform(-0.3, 0.3)))
    img = rotate(img, float(rng.uniform(-3.0, 3.0)))
    img = gamma_adjust(np.clip(img, 0, 1), float(rng.uniform(0.7, 1.4)))
    img = random_background(img, rng)
    return img
