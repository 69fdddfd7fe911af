"""Debug image sheets (the reference's ``write_image``,
GAN_word/modules_tro.py:47-105).

The port's copy of the word sheet of ``affganwriting_tpu/eval/sheets.py``:
per sample, a column of [two style rows, GT image, GT text, generated,
predicted text, swap GT text, swap generated, swap predicted text], the
text drawn with a built-in 5x7 bitmap font.  Without PIL a sheet is saved
as the uint8 array ``<name>.png.npy``.
"""

from __future__ import annotations

import os

import numpy as np

# Classic 5x7 GLCD font (public domain), ASCII 0x20-0x7E.  Each glyph is
# five column bytes, LSB = top pixel row.  10 hex chars per glyph.
_FONT5X7 = (
    "0000000000" "00005F0000" "0007000700" "147F147F14" "242A7F2A12"  # !"#$
    "2313086462" "3649552250" "0005030000" "001C224100" "0041221C00"  # %&'()
    "14083E0814" "08083E0808" "0050300000" "0808080808" "0060600000"  # *+,-.
    "2010080402" "3E5149453E" "00427F4000" "4261514946" "2141454B31"  # /0123
    "1814127F10" "2745454539" "3C4A494930" "0171090503" "3649494936"  # 45678
    "064949291E" "0036360000" "0056360000" "0814224100" "1414141414"  # 9:;<=
    "0041221408" "0201510906" "3249794132" "7E1111117E" "7F49494936"  # >?@AB
    "3E41414122" "7F4141221C" "7F49494941" "7F09090901" "3E4141512E"  # CDEFG
    "7F0808087F" "00417F4100" "2040413F01" "7F08142241" "7F40404040"  # HIJKL
    "7F020C027F" "7F0408107F" "3E4141413E" "7F09090906" "3E4151215E"  # MNOPQ
    "7F09192946" "4649494931" "01017F0101" "3F4040403F" "1F2040201F"  # RSTUV
    "3F4038403F" "6314081463" "0708700807" "6151494543" "007F414100"  # WXYZ[
    "0204081020" "0041417F00" "0402010204" "4040404040" "0001020400"  # \]^_`
    "2054545478" "7F48444438" "3844444420" "384444487F" "3854545418"  # abcde
    "087E090102" "0C5252523E" "7F08040478" "00447D4000" "2040443D00"  # fghij
    "7F10284400" "00417F4000" "7C04180478" "7C08040478" "3844444438"  # klmno
    "7C14141408" "081414187C" "7C08040408" "4854545420" "043F444020"  # pqrst
    "3C4040207C" "1C2040201C" "3C4030403C" "4428102844" "0C5050503C"  # uvwxy
    "4464544C44" "0008364100" "00007F0000" "0041360800" "1008081008"  # z{|}~
)


def _glyph(c: str) -> np.ndarray:
    """(7, 5) bool bitmap of a printable ASCII char ('?' for others)."""
    idx = ord(c) - 0x20
    if not 0 <= idx < 95:
        idx = ord("?") - 0x20
    cols = bytes.fromhex(_FONT5X7[idx * 10: idx * 10 + 10])
    out = np.zeros((7, 5), bool)
    for x, byte in enumerate(cols):
        for y in range(7):
            out[y, x] = bool(byte & (1 << y))
    return out


def _normalize(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-8:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def _text_strip(text: str, h: int, w: int) -> np.ndarray:
    """``text`` as white-on-black glyphs at the largest integer scale that
    fits (h, w)."""
    img = np.zeros((h, w), np.uint8)
    text = text or ""
    if not text:
        return img
    # 6 columns per char (5 glyph + 1 space) at integer scale s
    s = max(1, min((h - 2) // 8, (w - 2) // (6 * len(text))))
    x = 1
    y = max(0, (h - 7 * s) // 2)
    for c in text:
        if x + 5 * s > w:
            break
        tile = np.kron(_glyph(c), np.ones((s, s), bool))
        img[y: y + 7 * s, x: x + 5 * s][tile] = 255
        x += 6 * s
    return img


def write_sheet(
    out_dir: str,
    title: str,
    xg: np.ndarray,             # (B, H, W, 1) generated
    pred_texts: list[str],
    gt_img: np.ndarray,         # (B, H, W, 1) held-out real
    gt_texts: list[str],
    style_imgs: np.ndarray,     # (B, H, W, C>=2)
    xg_swap: np.ndarray,
    pred_texts_swap: list[str],
    gt_texts_swap: list[str],
    num_style_rows: int = 2,
) -> str:
    """Writes ``<out_dir>/<title>.png`` (``.png.npy`` without PIL) and
    returns the path it was asked for."""
    os.makedirs(out_dir, exist_ok=True)
    b, h, w, _ = xg.shape
    cols = []
    for i in range(b):
        rows = [_normalize(style_imgs[i, :, :, j])
                for j in range(num_style_rows)]
        rows.append(_normalize(gt_img[i, :, :, 0]))
        rows.append(_text_strip(gt_texts[i], h, w))
        rows.append(_normalize(xg[i, :, :, 0]))
        rows.append(_text_strip(pred_texts[i], h, w))
        rows.append(_text_strip(gt_texts_swap[i], h, w))
        rows.append(_normalize(xg_swap[i, :, :, 0]))
        rows.append(_text_strip(pred_texts_swap[i], h, w))
        cols.append(np.vstack(rows))
    path = os.path.join(out_dir, f"{title}.png")
    _save_png(path, np.hstack(cols))
    return path


def _save_png(path: str, gray: np.ndarray) -> None:
    try:
        from PIL import Image

        Image.fromarray(gray, mode="L").save(path)
    except Exception:
        np.save(path + ".npy", gray)  # without PIL
