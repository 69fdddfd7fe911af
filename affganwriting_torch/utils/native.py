"""ctypes loader of the native word-image preprocessing (``native/
preprocess.cpp`` at the root of the checkout).

The port of ``affganwriting_tpu/utils/native.py``: the word preprocessing,
the batched Otsu foreground masks and the batched mesh warp, which
``data/words.py`` and ``data/line_augment.py`` use, and the elastic and
affine warps of one image (``elastic_native``, ``affine_native``), which
no module of either package calls: ``tests/test_torch_native.py`` holds
them against the JAX package's wrappers and ``data/augment.py``.  Build
once with

    python -m affganwriting_torch.utils.native build

(one ``g++`` call, OpenMP) into ``build/native/`` at the root of the
checkout; ``preprocess_word_image`` then takes it for uint8 images, and
``foreground_mask`` and ``grid_warp_line`` for every image; without it
they take their numpy and scipy versions.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "preprocess.cpp"
SO = ROOT / "build" / "native" / "libpreprocess.so"

_lib = None


def build(verbose: bool = True) -> Path:
    """Compile ``SRC`` into ``SO`` (written aside, then renamed into
    place)."""
    SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = SO.with_name(f"{SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    os.replace(tmp, SO)
    return SO


def load():
    """The ctypes library, or None when it is not built or not loadable."""
    global _lib
    if _lib is not None:
        return _lib
    if not SO.is_file():
        return None
    try:
        lib = ctypes.CDLL(str(SO))
    except OSError:
        return None
    lib.preprocess_words.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int]
    f32p, i32 = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.otsu_fg_mask_batch.argtypes = [f32p, i32, i32, i32, f32p]
    lib.grid_warp_batch.argtypes = [f32p, i32, i32, i32, f32p, f32p, i32,
                                    i32, ctypes.c_float, f32p]
    lib.elastic_warp.argtypes = [f32p, f32p, i32, i32, f32p, f32p,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float]
    lib.affine_warp.argtypes = [f32p, f32p, i32, i32, ctypes.c_float,
                                ctypes.c_float, ctypes.c_float]
    for fn in (lib.otsu_fg_mask_batch, lib.grid_warp_batch,
               lib.elastic_warp, lib.affine_warp):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _built():
    lib = load()
    if lib is None:
        raise RuntimeError("the native library is not built: run python -m "
                           "affganwriting_torch.utils.native build")
    return lib


def preprocess_words_native(images: np.ndarray, out_h: int = 64,
                            out_w: int = 216) -> np.ndarray:
    """(N, H, W) uint8 -> (N, out_h, out_w) float32 in [-1, 1]."""
    lib = _built()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w = images.shape
    out = np.empty((n, out_h, out_w), np.float32)
    lib.preprocess_words(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w)
    return out


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def elastic_native(img: np.ndarray, rng: np.random.Generator,
                   alpha: float = 1750.0, sigma: float = 45.0) -> np.ndarray:
    """Elastic warp of one (H, W) image: displacement fields dx, then dy,
    drawn uniform in [-1, 1] from ``rng`` (the JAX wrapper's order), each
    Gaussian-blurred by ``sigma`` and scaled by ``alpha``; bilinear
    resampling, the image's minimum outside it."""
    lib = _built()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    dx = np.ascontiguousarray(rng.uniform(-1, 1, size=(h, w)), np.float32)
    dy = np.ascontiguousarray(rng.uniform(-1, 1, size=(h, w)), np.float32)
    out = np.empty_like(img)
    lib.elastic_warp(_f32p(img), _f32p(out), h, w, _f32p(dx), _f32p(dy),
                     alpha, sigma, float(img.min()))
    return out


def affine_native(img: np.ndarray, degrees: float = 0.0,
                  shear: float = 0.0) -> np.ndarray:
    """Rotation by ``degrees`` and horizontal shear by ``shear`` of one
    (H, W) image about its centre; bilinear resampling, the image's minimum
    outside it (``data/augment.py``'s ``rotate`` and ``shear``)."""
    lib = _built()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out = np.empty_like(img)
    lib.affine_warp(_f32p(img), _f32p(out), h, w, degrees, shear,
                    float(img.min()))
    return out


def otsu_fg_mask_native(imgs: np.ndarray) -> np.ndarray | None:
    """Batched Otsu foreground masks: (B, H, W) [0, 1] pages, ink dark ->
    {0, 1} float32.  None when the library is not built."""
    lib = load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.float32)
    b, h, w = imgs.shape
    out = np.empty_like(imgs)
    lib.otsu_fg_mask_batch(_f32p(imgs), b, h, w, _f32p(out))
    return out


def grid_warp_native(imgs: np.ndarray, dy_nodes: np.ndarray,
                     dx_nodes: np.ndarray, cval: float = 1.0
                     ) -> np.ndarray | None:
    """Batched mesh warp: imgs (B, H, W), each image's node offsets (B, GH,
    GW).  None when the library is not built."""
    lib = load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.float32)
    dy_nodes = np.ascontiguousarray(dy_nodes, np.float32)
    dx_nodes = np.ascontiguousarray(dx_nodes, np.float32)
    b, h, w = imgs.shape
    gh, gw = dy_nodes.shape[1:]
    out = np.empty_like(imgs)
    lib.grid_warp_batch(_f32p(imgs), b, h, w, _f32p(dy_nodes),
                        _f32p(dx_nodes), gh, gw, float(cval), _f32p(out))
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "build":
        print("built:", build())
    else:
        print("available:", available())
