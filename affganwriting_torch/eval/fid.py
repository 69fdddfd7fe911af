"""Batched FID with the reference's crop-64 protocol.

The port of ``affganwriting_tpu/eval/fid.py`` (the reference's
GAN_word/fid_folder/fid_score_crop64x64.py): images are cropped to their
first 64 columns, resized to 64x64, scaled to [0, 1], pushed through
InceptionV3 pool3 (2048-d, ``eval/inception_v3.py``) in batches on the
card, and FID is the Fréchet distance between the Gaussian fits of the two
activation sets (:215-269), its matrix square root taken on the host
(scipy), as in the reference.  The per-writer "WID" variant
(fid_score_crop64x64_wid.py) averages the distances of the writers both
sets have.

Without an InceptionV3 ``.pth`` the features are random, drawn from
``FIDScorer``'s seed by the port's own init (``random_features:torch:seed=N``)
on the CPU and then moved to the device, so the card and the CPU score with
the same features.  They are not the JAX package's random features (a flax
init), so the two packages' random-feature FIDs are not comparable.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from affganwriting_torch.eval.inception_v3 import InceptionV3Pool3
from affganwriting_torch.gen.inference import init_weights, resolve_device
from affganwriting_torch.models.blocks import resize_bilinear


def crop64_preprocess(images: np.ndarray) -> np.ndarray:
    """(B, H, W[, C]) any range -> (B, 64, 64, 3) float32 in [0, 1]: the
    first 64 columns, resized to 64x64 as ``jax.image.resize(...,
    "linear")`` does (antialiased where it shrinks)."""
    if images.ndim == 3:
        images = images[..., None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    images = images.astype(np.float32)
    if images.max() > 1.5:
        images = images / 255.0
    x = torch.from_numpy(np.ascontiguousarray(images[:, :, :64, :]))
    out = resize_bilinear(x.permute(0, 3, 1, 2), (64, 64))
    return out.clamp(0.0, 1.0).permute(0, 2, 3, 1).numpy()


# Places a torchvision/pytorch-fid InceptionV3 state dict is looked for.
# Drop one here (or set AFFGAN_INCEPTION_PTH) and every FID upgrades from
# the random-feature metric to the reference's pretrained-feature FID
# (fid_score_crop64x64.py:104-118).
_INCEPTION_PTH_CANDIDATES = (
    "inception_v3.pth",
    "pt_inception-2015-12-05-6726825d.pth",
    os.path.expanduser("~/.cache/affganwriting/inception_v3.pth"),
    os.path.expanduser(
        "~/.cache/affganwriting/pt_inception-2015-12-05-6726825d.pth"),
)


def find_inception_weights() -> Optional[str]:
    """Local InceptionV3 ``.pth`` to back FID with real features, if any."""
    env = os.environ.get("AFFGAN_INCEPTION_PTH")
    if env:
        return env if os.path.exists(env) else None
    for c in _INCEPTION_PTH_CANDIDATES:
        if os.path.exists(c):
            return c
    return None


class FIDScorer:
    """``provenance`` says which feature space the scores live in:

    * ``"pretrained:<path>"``: a local torchvision InceptionV3 state dict
      was found and loaded; scores compare with the reference's FID;
    * ``"caller_weights"``: ``weights``, a state dict of
      ``InceptionV3Pool3``;
    * ``"random_features:torch:seed=N"``: no weights; a fixed-seed random
      network.  Absolute values are not comparable to published FID, nor
      to the JAX package's random features, but with the seed pinned the
      number is a relative metric across checkpoints of the port.

    Runs on the card unless ``device="cpu"``."""

    def __init__(self, weights: Optional[dict] = None, seed: int = 0,
                 batch_size: int = 64, device=None):
        self.device = resolve_device(device)
        self.model = InceptionV3Pool3()
        if weights is not None:
            self.model.load_state_dict(weights)
            self.provenance = "caller_weights"
        else:
            init_weights(self.model, seed)
            self.provenance = f"random_features:torch:seed={seed}"
            pth = find_inception_weights()
            if pth is not None:
                from affganwriting_torch.utils.torchvision_import import (
                    inception_v3_state_dict,
                    load_state_dict,
                )

                self.model.load_state_dict(
                    inception_v3_state_dict(load_state_dict(pth)))
                self.provenance = f"pretrained:{pth}"
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.batch_size = batch_size

    @torch.inference_mode()
    def activations(self, images: np.ndarray) -> np.ndarray:
        """(B, 64, 64, 3) in [0, 1] -> (B, 2048) float32."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            chunk = torch.from_numpy(np.array(
                images[i: i + self.batch_size], np.float32)).to(self.device)
            outs.append(self.model(chunk.permute(0, 3, 1, 2)).cpu().numpy())
        return (np.concatenate(outs) if outs
                else np.zeros((0, 2048), np.float32))

    def fid(self, images_a: np.ndarray, images_b: np.ndarray) -> float:
        act_a = self.activations(crop64_preprocess(images_a))
        act_b = self.activations(crop64_preprocess(images_b))
        return frechet_distance(*gaussian_stats(act_a),
                                *gaussian_stats(act_b))

    def fid_per_writer(
        self, images_a: np.ndarray, writers_a: np.ndarray,
        images_b: np.ndarray, writers_b: np.ndarray,
    ) -> dict:
        """The WID metric: mean FID over writers present in both sets."""
        act_a = self.activations(crop64_preprocess(images_a))
        act_b = self.activations(crop64_preprocess(images_b))
        return wid_of_activations(act_a, writers_a, act_b, writers_b)


def wid_of_activations(act_a: np.ndarray, writers_a: np.ndarray,
                       act_b: np.ndarray, writers_b: np.ndarray) -> dict:
    """Mean Fréchet distance over the writers with at least 2 activations
    in each set, and each writer's."""
    common = sorted(set(writers_a.tolist()) & set(writers_b.tolist()))
    per = {}
    for w in common:
        a = act_a[writers_a == w]
        b = act_b[writers_b == w]
        if len(a) < 2 or len(b) < 2:
            continue
        per[w] = frechet_distance(*gaussian_stats(a), *gaussian_stats(b))
    mean = float(np.mean(list(per.values()))) if per else float("nan")
    return {"wid_fid": mean, "per_writer": per}


def gaussian_stats(act: np.ndarray):
    mu = act.mean(axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) with the reference's
    sqrtm stabilization (fid_score_crop64x64.py:215-269)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # the matrix alone: scipy 1.18 dropped ``disp=False`` and its
    # (sqrtm, error) pair
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm(
            (sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


# --- folder interface (CLI-compatible with the reference driver) -----------

_WID_RE = re.compile(r"^(?P<wid>[^-]+)-")
_PIL_EXTS = (".png", ".jpg", ".jpeg")


def _read_image(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 RGB of ``path``: a ``.png.npy`` array (gray
    replicated, as PIL's ``convert("RGB")`` does) or, through PIL, a
    ``.png``/``.jpg``/``.jpeg`` (None where PIL cannot read it).  Without
    PIL an image file raises: scoring would skip every one of them."""
    if path.lower().endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        return np.repeat(arr, 3, axis=-1) if arr.shape[-1] == 1 else arr
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: reading {os.path.splitext(path)[1]} images needs PIL, "
            "which is not installed; write the images as .png.npy "
            "(eval/sheets._save_png does so without PIL)") from None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32)
    except OSError:
        return None


def load_folder_images(folder: str, limit: Optional[int] = None):
    """Read the images of a folder -> (images (N, h, w, 3) cropped to the
    smallest h and w, writer ids (N,) from the ``<wid>-`` prefix)."""
    names = sorted(
        n for n in os.listdir(folder)
        if n.lower().endswith(".png.npy")
        or os.path.splitext(n)[1].lower() in _PIL_EXTS)
    if limit:
        names = names[:limit]
    imgs, wids = [], []
    for n in names:
        arr = _read_image(os.path.join(folder, n))
        if arr is None:
            continue
        imgs.append(arr)
        m = _WID_RE.match(n)
        wids.append(m.group("wid") if m else "?")
    if not imgs:
        return np.zeros((0, 64, 64, 3)), np.asarray([])
    h = min(a.shape[0] for a in imgs)
    w = min(a.shape[1] for a in imgs)
    imgs = np.stack([a[:h, :w] for a in imgs])
    return imgs, np.asarray(wids)


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("generated")
    p.add_argument("real")
    p.add_argument("--per-writer", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    scorer = FIDScorer(device=args.device)
    ga, gw = load_folder_images(args.generated, args.limit)
    ra, rw = load_folder_images(args.real, args.limit)
    key = ("fid" if scorer.provenance.startswith("pretrained")
           else "fid_random_features")
    if args.per_writer:
        out = scorer.fid_per_writer(ga, gw, ra, rw)
        print(json.dumps({f"wid_{key}": out["wid_fid"],
                          "fid_provenance": scorer.provenance}))
    else:
        print(json.dumps({key: scorer.fid(ga, ra),
                          "fid_provenance": scorer.provenance}))


if __name__ == "__main__":
    main()
