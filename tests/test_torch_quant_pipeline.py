"""The port's ``make_generate_and_read_quant_fn`` vs the JAX package's, f32
on the CPU: the small fp32 resnet50 config (tests/test_torch_support.py),
random flax leaves converted by ``utils/from_flax``, and the JAX package's
calibration carried across (R's qparams by ``vgg_qparams_from_flax``, G's
``"quant"`` collection by ``gen_quant_from_flax``), so that the comparison
does not hinge on the two packages' float calibration forwards.

- R's trunk in int8 with G float: images within 1e-3 (the float G, as in
  ``test_torch_pipeline.py`` but at 1e-3: 2e-3 there holds bf16-free f32
  through ~60 layers);
- G's decoder in int8 (``dynamic``, ``static``): images correlated above
  0.999 with the JAX package's (a code one step apart at a near-tie
  travels on; ``test_torch_quant.py`` holds each int8 site exactly);
- the greedy ids, R reading the JAX package's images on both sides: equal
  wherever the JAX logits' top-2 margin is above twice the packages'
  largest logit difference (``test_torch_htr.py``'s rule), with at least
  half of them clear; and each run's own ids equal wherever that margin
  clears twice the difference of the two runs' logits.

The JAX side runs jitted: R's program once, G's once per int8 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.ops.quant as jq
from affganwriting_tpu.gen.inference import (
    calibrate_gen_quant as jax_calibrate_gen_quant,
)
from affganwriting_tpu.gen.inference import (
    make_generate_and_read_quant_fn as jax_quant_fn,
)
from affganwriting_tpu.train.state import build_models as jax_build_models
from affganwriting_torch.gen.inference import (
    encode_labels,
    make_generate_and_read_quant_fn,
)
from affganwriting_torch.ops.quant import vgg_quant_apply
from affganwriting_torch.utils.from_flax import (
    from_flax,
    gen_quant_from_flax,
    vgg_qparams_from_flax,
)
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
def setup():
    """Random flax leaves, one style stack and labels, the JAX package's
    calibration on them, its float G's images and its jitted R reading."""
    jcfg = small_jax_config()
    gen, _, _, rec = jax_build_models(jcfg)
    shape = (1, jcfg.img_height, jcfg.img_width, jcfg.style_stack)
    labels = encode_labels(WORDS, jcfg.output_max_len)
    gv = random_variables(gen, np.zeros(shape, np.float32), labels[:1],
                          seed=1)
    rv = random_variables(rec, np.zeros(shape[:3] + (1,), np.float32),
                          labels[:1], seed=2)
    style = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    gvj, rvj = (jax.tree.map(jnp.asarray, t) for t in (gv, rv))
    gv_cal = jax_calibrate_gen_quant(jcfg, gvj, style, labels)
    float_imgs = jax_quant_fn(jcfg).run_gen(gvj, style, labels)
    qp = jq.prepare_vgg_quant(rvj, float_imgs)

    @jax.jit
    def read(images):
        """``run_rec`` of the JAX pipeline, returning the logits."""
        feat = jq.vgg_quant_apply(qp, images)
        return rec.apply(rvj, feat, labels, method=rec.read_features)[0]

    return {"jcfg": jcfg, "gv": gv, "rv": rv, "gv_cal": gv_cal, "qp": qp,
            "style": style, "labels": labels, "read": read,
            "float_imgs": np.asarray(float_imgs)}


def _clear(want_logits, gap):
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * gap


@pytest.mark.parametrize("quant_gen", [False, "dynamic", "static"])
def test_generate_and_read_quant_matches_jax(setup, quant_gen):
    s = setup
    # the JAX pipeline's two programs: run_gen, then run_rec (whose argmax
    # over these logits gives its ids); the float G's images are setup's
    if quant_gen:
        want_img = np.asarray(jax_quant_fn(s["jcfg"], quant_gen=quant_gen)
                              .run_gen(s["gv_cal"], s["style"], s["labels"]))
    else:
        want_img = s["float_imgs"]
    want_logits = np.asarray(s["read"](want_img))
    want_ids = want_logits.argmax(-1)
    gs, rs = from_flax(to_numpy_tree(s["gv"]), to_numpy_tree(s["rv"]),
                       small_torch_config())
    run = make_generate_and_read_quant_fn(
        small_torch_config(), gs, rs, quant_gen=quant_gen, device="cpu",
        qparams=vgg_qparams_from_flax(to_numpy_tree(s["qp"])),
        gen_quant=gen_quant_from_flax(to_numpy_tree(s["gv_cal"]["quant"])))
    images, ids = run(s["style"], s["labels"])
    assert images.shape == want_img.shape and ids.shape == (4, 7)
    if quant_gen:
        corr = np.corrcoef(images.numpy().ravel(), want_img.ravel())[0, 1]
        assert corr > 0.999, corr
    else:
        close(images, want_img, 1e-3, "images")

    # R on the JAX package's images on both sides
    lab = torch.from_numpy(s["labels"]).long()
    with torch.inference_mode():
        def port_logits(imgs):
            imgs = torch.as_tensor(np.array(imgs)).permute(0, 3, 1, 2)
            feat = vgg_quant_apply(run.qparams, imgs)
            return run.rec.read_features(feat, lab)[0].numpy()

        logits = port_logits(want_img)
        own_logits = port_logits(images)
        read_ids = run.run_rec(torch.from_numpy(np.array(want_img)),
                               s["labels"])
    gap = float(np.abs(logits - want_logits).max())
    clear = _clear(want_logits, gap)
    assert clear.mean() >= 0.5, (gap, clear.mean())
    assert (read_ids.numpy() == np.asarray(want_ids))[clear].all(), gap
    # each run's own images and ids
    own_gap = float(np.abs(own_logits - want_logits).max())
    own_clear = _clear(want_logits, own_gap)
    assert (ids.numpy() == np.asarray(want_ids))[own_clear].all(), own_gap
