"""The port's generate-and-recognize path vs the JAX package's, plus the
config round-trip and the weight converter's leaf accounting.

Small fp32 resnet50 config, random flax leaves converted by
``utils/from_flax``.  Tolerance 2e-3 on the images (atol/rtol): f32
summation-order differences through the ~60 layers of G; greedy ids
identical.  The JAX pipeline runs with jit disabled (eager), which skips
its CPU compiles and computes the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affganwriting_tpu.core.config import WordGanConfig as JConfig
from affganwriting_tpu.gen.inference import (
    make_generate_and_read_fn as jax_generate_and_read,
)
from affganwriting_tpu.train.state import build_models as jax_build_models
from affganwriting_torch.core.config import WordGanConfig as TConfig
from affganwriting_torch.gen.inference import (
    encode_labels,
    make_generate_and_read_fn,
)
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
def variables():
    cfg = small_jax_config()
    gen, _, _, rec = jax_build_models(cfg)
    style = np.zeros((1, cfg.img_height, cfg.img_width, cfg.style_stack),
                     np.float32)
    labels = encode_labels(WORDS[:1], cfg.output_max_len)
    img = np.zeros((1, cfg.img_height, cfg.img_width, 1), np.float32)
    return (random_variables(gen, style, labels, seed=1),
            random_variables(rec, img, labels, seed=2))


@pytest.fixture(scope="module")
def port_run(variables):
    gen_state, rec_state = from_flax(*map(to_numpy_tree, variables),
                                     small_torch_config())
    return make_generate_and_read_fn(small_torch_config(), gen_state,
                                     rec_state, device="cpu")


@pytest.mark.parametrize("writers", [1, 2])
def test_generate_and_read_matches_jax(variables, port_run, writers):
    cfg = small_jax_config()
    rng = np.random.default_rng(writers)
    style = rng.normal(size=(writers, cfg.img_height, cfg.img_width,
                             cfg.style_stack)).astype(np.float32)
    labels = encode_labels(WORDS, cfg.output_max_len)
    with jax.disable_jit():
        want_img, want_ids = jax_generate_and_read(cfg)(
            *variables, jnp.asarray(style), jnp.asarray(labels))
    images, ids = port_run(style, labels)
    assert images.shape == (4, cfg.img_height, cfg.img_width, 1)
    assert ids.shape == (4, cfg.output_max_len - 1)
    close(images, want_img, 2e-3, "images")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))


def test_batch_not_multiple_of_writers_raises(port_run):
    cfg = small_torch_config()
    style = np.zeros((3, cfg.img_height, cfg.img_width, cfg.style_stack),
                     np.float32)
    with pytest.raises(ValueError, match="not a multiple of the 3 style"):
        port_run(style, encode_labels(WORDS, cfg.output_max_len))


@pytest.mark.parametrize("start", ["jax", "torch"])
def test_config_json_round_trips_across_packages(start):
    cfg = (JConfig() if start == "jax" else TConfig()).replace(
        img_width=104, trocr_map_vec=(1, 2, 3), compute_dtype="float32")
    other = TConfig if start == "jax" else JConfig
    back = other.from_json(cfg.to_json())
    assert back.to_json() == cfg.to_json()
    assert back.trocr_map_vec == (1, 2, 3)
    assert back.output_max_len == cfg.output_max_len == 12


def test_from_flax_accounts_for_every_leaf(variables):
    gen_np, rec_np = map(to_numpy_tree, variables)
    cfg = small_torch_config()
    gen_sd, rec_sd = from_flax(gen_np, rec_np, cfg)
    n_leaves = len(jax.tree.leaves(gen_np))
    # every flax leaf lands in the port; BiGRU/GRU cells merge 6 gates
    assert len(gen_sd) == n_leaves
    assert "enc.rnn.gru1.weight_ih_l0_reverse" in rec_sd
    np.testing.assert_array_equal(
        rec_sd["enc.rnn.gru0.bias_hh_l0"][:128].numpy(), 0)

    extra = jax.tree.map(lambda x: x, gen_np)
    extra["params"]["dec"]["head"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="not consumed.*head/stray"):
        from_flax(extra, rec_np, cfg)

    missing = jax.tree.map(lambda x: x, rec_np)
    del missing["batch_stats"]["enc"]["vgg"]["bn3"]["var"]
    with pytest.raises(ValueError, match="not filled.*bn3.running_var"):
        from_flax(gen_np, missing, cfg)

    swapped = jax.tree.map(lambda x: x, gen_np)
    up = swapped["params"]["dec"]["up0"]
    up["kernel"] = np.swapaxes(up["kernel"], 2, 3)
    with pytest.raises(ValueError, match="shape mismatches.*up0.weight"):
        from_flax(swapped, rec_np, cfg)


def test_build_models_is_seeded_and_matches_the_converter(variables):
    from affganwriting_torch.gen.inference import build_models

    cfg = small_torch_config()
    (g1, r1), (g2, _) = (build_models(cfg, "cpu"),
                         build_models(cfg, device="cpu"))
    gen_sd, rec_sd = from_flax(*map(to_numpy_tree, variables), cfg)
    assert set(g1.state_dict()) == set(gen_sd)
    assert set(r1.state_dict()) == set(rec_sd)
    for k, v in g1.state_dict().items():
        assert torch.equal(v, g2.state_dict()[k]), k
    assert not any(p.requires_grad for p in g1.parameters())
