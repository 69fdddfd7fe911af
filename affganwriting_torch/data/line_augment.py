"""Line-image augmentation and Otsu foreground masks.

The port's copy of ``affganwriting_tpu/data/line_augment.py`` (numpy and
scipy, bit-equal), the line pipeline's host-side augmentation
(line_generation/utils/augmentation.py, utils/grid_distortion.py) and the
fg-mask precompute of ``AuthorHWDataset`` (author_hw_dataset.py:200-229):

- :func:`otsu_threshold` / :func:`foreground_mask`: Otsu binarize, invert
  (ink = 1), dilate with a 9x9 ellipse; the trainer multiplies both real
  and recon by this mask for the no-background pixel loss
  (hw_with_style_trainer.py:607-611).
- :func:`tensmeyer_brightness`: Otsu-split additive brightness jitter on
  foreground and background separately (augmentation.py:5-31).
- :func:`affine_skew_stretch`: the skew/stretch warpAffine
  (augmentation.py:61-72).
- :func:`grid_warp_line`: the mesh-perturbation warp
  (grid_distortion.py:11-77) via bilinearly upsampled per-node offsets.

``foreground_mask`` and ``grid_warp_line`` take the C++ batch routines of
``native/preprocess.cpp`` when the library is built
(``utils/native.py``), the scipy route otherwise, as the JAX package
does; both are host preprocessing.  Images are float32 grayscale in
[0, 1] with ink dark (page convention) unless noted.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def otsu_threshold(img01: np.ndarray) -> float:
    """Otsu's threshold of a [0, 1] grayscale image (256-bin)."""
    hist, edges = np.histogram(img01, bins=256, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.5
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = total - w0
    mu0 = np.cumsum(hist * centers) / np.maximum(w0, 1e-12)
    mu_total = (hist * centers).sum() / total
    mu1 = (mu_total * total - np.cumsum(hist * centers)) / np.maximum(
        w1, 1e-12)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between[(w0 == 0) | (w1 == 0)] = -1
    # upper edge of the argmax bin: the dark class (values <= threshold)
    # must include its own bin
    return float(edges[int(np.argmax(between)) + 1])


def _ellipse(size: int = 9) -> np.ndarray:
    r = size / 2.0
    yy, xx = np.mgrid[:size, :size]
    return ((yy - (size - 1) / 2) ** 2 + (xx - (size - 1) / 2) ** 2
            <= r * r).astype(bool)


def foreground_mask(img01: np.ndarray, dilate: int = 9) -> np.ndarray:
    """Ink mask: Otsu binarize -> invert -> 9x9 ellipse dilation
    (author_hw_dataset.py:224-228).  Returns float32 {0, 1}.

    Takes the C++ batch routine (native/preprocess.cpp) when it is built.
    """
    if dilate == 9:
        from affganwriting_torch.utils.native import otsu_fg_mask_native

        out = otsu_fg_mask_native(img01[None])
        if out is not None:
            return out[0]
    th = otsu_threshold(img01)
    ink = img01 < th
    if dilate > 1:
        ink = ndimage.binary_dilation(ink, structure=_ellipse(dilate))
    return ink.astype(np.float32)


def tensmeyer_brightness(img01: np.ndarray, rng: np.random.Generator,
                         sigma: float = 30.0) -> np.ndarray:
    """Foreground/background-split brightness jitter
    (augmentation.py:5-31; sigma in 0-255 units)."""
    th = otsu_threshold(img01)
    bg = (img01 >= th).astype(np.float32)
    fg_shift = rng.normal(0.0, sigma) / 255.0
    bg_shift = rng.normal(0.0, sigma) / 255.0
    out = img01 + (1.0 - bg) * fg_shift + bg * bg_shift
    return np.clip(out, 0.0, 1.0)


def affine_skew_stretch(img01: np.ndarray, skew: float,
                        stretch: float, cval: float = 1.0) -> np.ndarray:
    """Horizontal skew (radians) + width stretch (augmentation.py:61-72).
    Output width scales by ``stretch``."""
    h, w = img01.shape
    m = np.tan(skew)
    out_w = max(1, int(round(w * stretch)))
    # inverse map: out (y, x) <- in (y, x/stretch - m*(y - h/2)... the
    # reference's forward matrix [[stretch, m, -h/2*m], [0, 1, 0]] maps
    # (x_in, y_in) -> (stretch*x_in + m*y_in - h/2*m, y_in); invert:
    inv = np.array([[1.0, 0.0],
                    [-m / stretch, 1.0 / stretch]])
    offset = np.array([0.0, (h / 2.0) * m / stretch])
    return ndimage.affine_transform(
        img01, inv, offset=offset, output_shape=(h, out_w),
        order=1, mode="constant", cval=cval).astype(np.float32)


def grid_warp_line(img01: np.ndarray, rng: np.random.Generator,
                   mesh_interval: float = 12.0, mesh_std: float = 1.5,
                   cval: float = 1.0) -> np.ndarray:
    """Mesh-perturbation warp (grid_distortion.py:11-77): a regular
    control mesh is jittered by N(0, mesh_std) and pixels resample along
    the smoothly-interpolated displacement field."""
    h, w = img01.shape
    if h <= 5 or w <= 5:
        return img01
    gh = max(1, round(h / mesh_interval)) + 1
    gw = max(1, round(w / mesh_interval)) + 1
    dy = rng.normal(0.0, mesh_std, size=(gh, gw)).astype(np.float32)
    dx = rng.normal(0.0, mesh_std, size=(gh, gw)).astype(np.float32)
    from affganwriting_torch.utils.native import grid_warp_native

    native_out = grid_warp_native(img01[None], dy[None], dx[None], cval)
    if native_out is not None:
        return native_out[0]
    zy = (h - 1) / max(gh - 1, 1)
    zx = (w - 1) / max(gw - 1, 1)
    dy_full = ndimage.zoom(dy, (zy, zx), order=1)[:h, :w]
    dx_full = ndimage.zoom(dx, (zy, zx), order=1)[:h, :w]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = np.stack([yy + dy_full, xx + dx_full])
    return ndimage.map_coordinates(
        img01, coords, order=1, mode="constant", cval=cval
    ).astype(np.float32)


def augment_line(img01: np.ndarray, rng: np.random.Generator,
                 brightness_sigma: float = 30.0,
                 max_skew: float = 0.1, stretch_range=(0.9, 1.1),
                 warp_std: float = 1.5) -> np.ndarray:
    """The dataset's train-time chain (author_hw_dataset.py:291-299):
    brightness jitter -> small affine skew/stretch -> grid warp."""
    out = tensmeyer_brightness(img01, rng, brightness_sigma)
    skew = float(rng.uniform(-max_skew, max_skew))
    stretch = float(rng.uniform(*stretch_range))
    out = affine_skew_stretch(out, skew, stretch)
    return grid_warp_line(out, rng, mesh_std=warp_std)
