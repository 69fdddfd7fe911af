"""Line height/slant normalization: deskew + skeleton re-inking.

The port's copy of ``affganwriting_tpu/data/normalize_line.py`` (numpy,
bit-equal): the reference's line_generation/utils/normalize_line.py:1-84,
used by its line datasets.  ``deskew`` finds the dominant slant with the
two-pass angled projection-profile variance search (coarse 22-degree sweep,
then a 3x-finer refine around the winner) and shears it out;
``skeletonize`` Otsu-binarizes (the port's ``data/line_augment.
otsu_threshold``), thins to a one-pixel skeleton (Zhang-Suen), then
re-inks with a circular dilation and a 3x3 box blur.
"""

from __future__ import annotations

import math

import numpy as np

from affganwriting_torch.data.line_augment import otsu_threshold


def _angled_profile_var(v_img: np.ndarray, angle: float, x_step: int
                        ) -> float:
    """Variance of ink mass along lines at ``angle`` from vertical
    (normalize_line.py:18-28: np.linspace sampling per column)."""
    h, w = v_img.shape
    x_diff = math.tan(angle) * h - 1
    length = int(np.hypot(x_diff, h - 1))
    if length < 2:
        length = 2
    ys = np.linspace(0, h - 1, length).astype(np.int64)
    dxs = np.linspace(0, x_diff, length)
    xs0 = np.arange(0, w, x_step, dtype=np.float64)
    # only starts whose angled line stays inside the image (reference
    # skips x_end >= width)
    xs0 = xs0[xs0 + x_diff < w]
    if xs0.size == 0:
        return 0.0
    cols = (xs0[None, :] + dxs[:, None]).astype(np.int64)  # (L, X)
    vals = v_img[ys[:, None], cols].sum(axis=0) / h
    return float(np.var(vals))


def deskew(img: np.ndarray, angle_range: float = 0.38,
           angle_step: float = 0.076, x_step: int = 2) -> np.ndarray:
    """Shear the dominant slant out of a [0, 255] gray line image.

    Maximizes the variance of angled projection profiles — slant-aligned
    integration makes ink columns peaky — coarse then refined
    (normalize_line.py:9-64), then applies the inverse shear about the
    line with border 255."""
    img = np.asarray(img, np.float32)
    v_img = 1.0 - img / 255.0
    # Gaussian blur sigma 1.5 (separable, radius 4)
    r = 4
    k = np.exp(-np.arange(-r, r + 1) ** 2 / (2 * 1.5 ** 2))
    k /= k.sum()
    pad = np.pad(v_img, ((r, r), (r, r)), mode="edge")
    sm = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 0, pad)
    sm = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 1, sm)

    best_angle, best_shift, max_var = 0.0, 0.0, -1.0
    for angle in np.arange(-angle_range, angle_range + 1e-3, angle_step):
        var = _angled_profile_var(sm, float(angle), x_step)
        if var > max_var:
            max_var, best_angle = var, float(angle)
            best_shift = math.tan(angle) * img.shape[0] - 1
    max_var = -1.0
    for angle in np.arange(best_angle - angle_step,
                           best_angle + angle_step + 1e-3, angle_step / 3):
        var = _angled_profile_var(sm, float(angle), max(1, x_step // 2))
        if var > max_var:
            max_var = var
            best_shift = math.tan(float(angle)) * img.shape[0] - 1

    # cv2.warpAffine(M) with M = [[1, tan(-angle), shift/2], [0, 1, 0]]
    # treats M as src->dst and inverts it internally: the output samples
    # the input at x' = x - tan(-angle)*y - shift/2 = x + tan(angle)*y
    # - shift/2 — the slant is pulled back to vertical about the center
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tan_a = best_shift / max(h - 1, 1)    # tan(best_angle), -1 quirk kept
    src_x = xx + tan_a * yy - best_shift / 2.0
    x0 = np.floor(src_x).astype(np.int64)
    frac = src_x - x0
    inside0 = (x0 >= 0) & (x0 < w)
    inside1 = (x0 + 1 >= 0) & (x0 + 1 < w)
    g0 = np.where(inside0, img[yy.astype(np.int64), np.clip(x0, 0, w - 1)],
                  255.0)
    g1 = np.where(inside1,
                  img[yy.astype(np.int64), np.clip(x0 + 1, 0, w - 1)],
                  255.0)
    return (g0 * (1 - frac) + g1 * frac).astype(np.float32)


def _zhang_suen(mask: np.ndarray, max_iter: int = 100) -> np.ndarray:
    """One-pixel skeleton of a boolean ink mask (Zhang-Suen thinning)."""
    img = mask.astype(np.uint8).copy()

    def neighbors(p):
        p2 = np.roll(p, 1, 0)
        p3 = np.roll(np.roll(p, 1, 0), -1, 1)
        p4 = np.roll(p, -1, 1)
        p5 = np.roll(np.roll(p, -1, 0), -1, 1)
        p6 = np.roll(p, -1, 0)
        p7 = np.roll(np.roll(p, -1, 0), 1, 1)
        p8 = np.roll(p, 1, 1)
        p9 = np.roll(np.roll(p, 1, 0), 1, 1)
        return p2, p3, p4, p5, p6, p7, p8, p9

    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = neighbors(img)
            ring = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
            b = sum(ring[:-1])
            a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).astype(np.uint8)
                    for i in range(8))
            if phase == 0:
                c1 = p2 * p4 * p6
                c2 = p4 * p6 * p8
            else:
                c1 = p2 * p4 * p8
                c2 = p2 * p6 * p8
            cond = ((img == 1) & (b >= 2) & (b <= 6) & (a == 1)
                    & (c1 == 0) & (c2 == 0))
            if cond.any():
                img[cond] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


def skeletonize(img: np.ndarray) -> np.ndarray:
    """[0, 255] gray line -> normalized-stroke-width re-inked line
    (normalize_line.py:66-84): Otsu binarize the inverted image, thin to a
    skeleton, dilate with a radius-1 disc, 3x3 box blur, re-invert."""
    img = np.asarray(img, np.float32)
    inv01 = (255.0 - img) / 255.0
    th = otsu_threshold(inv01)
    mask = inv01 > th
    skel = _zhang_suen(mask).astype(np.float32) * 255.0

    # circular dilate, kernel 3 (disc radius 1 -> plus-shaped stencil)
    d = np.maximum.reduce([
        skel,
        np.roll(skel, 1, 0), np.roll(skel, -1, 0),
        np.roll(skel, 1, 1), np.roll(skel, -1, 1)])
    # 3x3 average blur with same padding
    pad = np.pad(d, 1, mode="constant")
    out = sum(pad[i:i + d.shape[0], j:j + d.shape[1]]
              for i in range(3) for j in range(3)) / 9.0
    return 255.0 - out
