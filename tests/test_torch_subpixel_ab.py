"""``tools/ab_subpixel_quality`` (the port of
``scripts/ab_subpixel_quality.py``) vs the JAX package, f32 on the CPU.

Random flax leaves of the small fp32 config (G seed 1, R seed 2, as
tests/test_torch_pipeline.py) converted by ``utils/from_flax``; two style
stacks and the four words of that test.  The tool's fast and exact images
each match the JAX ``Generator(cfg, subpixel=True/False)``'s within 2e-3
(f32 summation order through G, as tests/test_torch_pipeline.py), and its
``image_mse`` and ``image_corr`` match the JAX script's formulas on the
JAX images within 1e-4.  ``main`` runs on a saved checkpoint of that
config; on random weights its CER says nothing.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.models.generator import Generator as JGenerator
from affganwriting_tpu.train.state import build_models as jax_build_models
from affganwriting_torch.core.checkpoint import CheckpointManager
from affganwriting_torch.gen.inference import encode_labels
from affganwriting_torch.tools import ab_subpixel_quality
from affganwriting_torch.train.state import init_state
from affganwriting_torch.utils.from_flax import from_flax
from test_torch_support import (
    close,
    random_variables,
    small_jax_config,
    small_torch_config,
    to_numpy_tree,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

WORDS = ["deep", "tpu", "Hopper", "kernel"]


@pytest.fixture(scope="module")
def runs():
    cfg = small_jax_config()
    gen, _, _, rec = jax_build_models(cfg)
    labels = encode_labels(WORDS, cfg.output_max_len)
    zeros = np.zeros((1, cfg.img_height, cfg.img_width, cfg.style_stack),
                     np.float32)
    gen_v = random_variables(gen, zeros, labels[:1], seed=1)
    rec_v = random_variables(rec, zeros[..., :1], labels[:1], seed=2)
    rng = np.random.default_rng(7)
    stacks = [rng.normal(size=zeros.shape).astype(np.float32)
              for _ in range(2)]
    want = {}
    for mode, subpixel in (("fast", True), ("exact", False)):
        apply = jax.jit(JGenerator(cfg, subpixel=subpixel).apply)
        want[mode] = [np.asarray(apply(gen_v, jnp.asarray(s),
                                       jnp.asarray(labels)))
                      for s in stacks]
    gen_sd, rec_sd = from_flax(*map(to_numpy_tree, (gen_v, rec_v)),
                               small_torch_config())
    got = ab_subpixel_quality.subpixel_ab(small_torch_config(), gen_sd,
                                          rec_sd, stacks, labels, "cpu")
    return got, want


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_each_mode_matches_the_jax_generator(runs, mode):
    got, want = runs
    assert len(got["images"][mode]) == len(want[mode]) == 2
    for g, w in zip(got["images"][mode], want[mode]):
        assert g.shape == w.shape == (4, 32, 104, 1)
        close(g, w, 2e-3, mode)


def test_image_agreement_matches_the_jax_scripts_formulas(runs):
    got, want = runs
    pairs = list(zip(want["fast"], want["exact"]))
    mse = np.mean([np.mean((a - b) ** 2) for a, b in pairs])
    corr = np.mean([np.corrcoef(a.ravel(), b.ravel())[0, 1]
                    for a, b in pairs])
    assert abs(got["image_mse"] - mse) <= 1e-4, (got["image_mse"], mse)
    assert abs(got["image_corr"] - corr) <= 1e-4, (got["image_corr"], corr)
    assert 0 < got["image_mse"] and got["image_corr"] < 1  # modes differ


def test_cer_of_each_mode_counts_every_word(runs):
    got, _ = runs
    for mode in ("fast", "exact"):
        assert got[mode]["count"] == 2 * len(WORDS)
        assert got[mode]["cer"] >= 0
    assert got["delta_cer_fast_minus_exact"] == \
        got["fast"]["cer"] - got["exact"]["cer"]


def test_main_on_a_checkpoint(tmp_path, capsys):
    cfg = small_torch_config()
    CheckpointManager(str(tmp_path)).save(
        "best", init_state(cfg, "cpu", seed=0), cfg)
    out = ab_subpixel_quality.main(["--ckpt", str(tmp_path), "--writers",
                                    "2", "--words", "4", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert set(out) == {"ckpt", "writers", "words", "fast", "exact",
                        "delta_cer_fast_minus_exact", "image_mse",
                        "image_corr"}
    assert out["writers"] == 2 and out["words"] == 4
    assert out["fast"]["count"] == out["exact"]["count"] == 8
    assert 0 <= out["image_mse"] and -1 <= out["image_corr"] <= 1
