"""The port's single-card entry point: ``entry()`` returns the batched
generate function at ``default_config()`` and example arguments.

Modelled on ``__graft_entry__.py:entry`` of the JAX package: resnet50 G,
64x216 words in bf16, random weights from seed 0, one writer's 50-image
style stack from ``np.random.default_rng(0)`` and 8 words.  The function is
``gen/inference.py:make_generate_fn``'s: ``fn(*args)`` returns the images
(8, 64, 216, 1), generated with both CUDA kernels on the card.  It runs on
the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import numpy as np

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]


def entry(device=None):
    """(generate, (style_stack (1, 64, 216, 50), labels (8, 12)))."""
    from affganwriting_torch.core.config import default_config
    from affganwriting_torch.gen.inference import (
        encode_labels,
        make_generate_fn,
    )

    cfg = default_config()
    fn = make_generate_fn(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    style = np.asarray(
        rng.normal(size=(1, cfg.img_height, cfg.img_width, cfg.style_stack)),
        np.float32)
    return fn, (style, encode_labels(WORDS, cfg.output_max_len))


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry ok: {tuple(fn(*args).shape)}")
