"""Emuru autoregressive backend: the discovery of a local snapshot.

The port of ``affganwriting_tpu/serve/emuru.py``: the reference's
alternative web-app backend
(line_generation/app.py:152-215 + emuru_infer.py:1-41): the HF
``blowing-up-groundhogs/emuru`` model generates a styled line from a style
image + its transcription + the target text.  Weights are never
downloaded — a local snapshot is discovered under ``EMURU_DIR`` (a
snapshot dir holding config.json + model.safetensors) or the HF hub
cache; without one, ``load_emuru`` raises a clean ``FileNotFoundError``
and the web app hides the backend.

The model ships its own remote-code implementation (``transformers``,
imported only by ``load_emuru``); the GAN backend serves the app's main
path.
"""

from __future__ import annotations

import os
import re
import unicodedata

_MODEL = None

_HUB_SUBDIR = os.path.join(
    "models--blowing-up-groundhogs--emuru", "snapshots")


def find_local_snapshot() -> str:
    """EMURU_DIR (direct snapshot dir) or the newest complete snapshot in
    the HF hub cache (app.py:161-175).  Raises FileNotFoundError."""
    direct = os.environ.get("EMURU_DIR")
    if direct:
        if _is_snapshot(direct):
            return direct
        # EMURU_DIR may point at a hub-cache root too
        found = _newest_snapshot(os.path.join(direct, _HUB_SUBDIR))
        if found:
            return found
        raise FileNotFoundError(
            f"EMURU_DIR={direct} holds no complete Emuru snapshot "
            "(need config.json + model.safetensors)")
    cache_root = os.environ.get(
        "HUGGINGFACE_HUB_CACHE",
        os.path.expanduser("~/.cache/huggingface/hub"))
    found = _newest_snapshot(os.path.join(cache_root, _HUB_SUBDIR))
    if found:
        return found
    raise FileNotFoundError(
        "no local Emuru snapshot (set EMURU_DIR or populate the HF cache)")


def _is_snapshot(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, "config.json"))
            and os.path.isfile(os.path.join(path, "model.safetensors")))


def _newest_snapshot(base: str) -> str | None:
    if not os.path.isdir(base):
        return None
    candidates = [
        (os.path.getmtime(p), p)
        for name in os.listdir(base)
        if _is_snapshot(p := os.path.join(base, name))
    ]
    return max(candidates)[1] if candidates else None


def available() -> bool:
    try:
        find_local_snapshot()
        return True
    except FileNotFoundError:
        return False


def load_emuru():
    """Load (and cache) the local snapshot.  Raises FileNotFoundError when
    no snapshot exists; ImportError without transformers/torch."""
    global _MODEL
    if _MODEL is None:
        snapshot = find_local_snapshot()
        from transformers import AutoModel

        _MODEL = AutoModel.from_pretrained(
            snapshot, trust_remote_code=True, local_files_only=True).eval()
    return _MODEL


def prep_style_image(pil):
    """PIL -> (1, C, H, W) torch tensor: RGB, height 64 preserving aspect,
    [-1, 1] (emuru_infer.py:10-18)."""
    import numpy as np
    import torch

    img = pil.convert("RGB")
    h = 64
    w = max(1, img.width * h // img.height)
    arr = np.asarray(img.resize((w, h)), np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return torch.from_numpy(arr.transpose(2, 0, 1))[None]


def normalize_text(text: str) -> str:
    """NFKC + smart-quote folding + whitespace squeeze (app.py:196-201)."""
    s = unicodedata.normalize("NFKC", text)
    s = s.replace("’", "'").replace("‘", "'")
    s = s.replace("“", '"').replace("”", '"')
    return re.sub(r"\s+", " ", s).strip()


def generate_emuru(style_img_pil, style_text: str, gen_text: str,
                   max_tokens: int = 150):
    """Style image + its transcription + target text -> generated PIL line
    (app.py:203-215: token budget scales with text length, output
    upsampled to height 96)."""
    import torch
    from PIL import Image

    model = load_emuru()
    style_img = prep_style_image(style_img_pil)
    style_text = normalize_text(style_text)
    gen_text = normalize_text(gen_text)
    max_tokens = min(max(max_tokens, len(gen_text) * 5), 150)
    with torch.inference_mode():
        out = model.generate(style_text=style_text, gen_text=gen_text,
                             style_img=style_img, max_new_tokens=max_tokens)
    target_h = 96
    if out.height != target_h:
        out = out.resize(
            (int(out.width * target_h / out.height), target_h),
            Image.BICUBIC)
    return out
