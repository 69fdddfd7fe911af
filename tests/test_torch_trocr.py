"""The port's TrOCR drop-in recognizer vs the JAX package's, f32 on the CPU.

- ``TrOCRRecognizer`` at ``TrOCRArch.tiny()`` from the same random flax
  leaves (converted by ``utils/from_flax``): logits within 1e-4 of
  max(1, |JAX|) and the gradient into the images within 1e-4 of the largest
  JAX entry (measured: 1.8e-6 max abs, and 2.2e-6 of that entry);
- ``preprocess_for_trocr``: values within 1e-6, its vector-Jacobian product
  within 1e-6 (the resize is ``jax.image.resize``'s bilinear);
- the char->token tables: equal;
- ``import_torch_state_dict`` on a HF ``VisionEncoderDecoderModel`` built
  here from tiny configs: equal, tensor for tensor, to the JAX importer's
  tree converted by ``trocr_core_from_flax``; the port's logits against
  ``transformers``' own within 1e-3 (max abs), because the port, like the
  JAX package, keeps flax's LayerNorm eps 1e-6 where HF's ViT has 1e-12
  and its TrOCR decoder 1e-5 (measured 1.5e-4); with HF's eps put back in
  the port's LayerNorms, within 2e-5 (measured 1.7e-6);
- ``load_pretrained`` on a directory this file saves (with and without a
  tokenizer) as the JAX package's; ``None`` for a missing directory;
- one merged train step with R frozen (``rec_frozen``): the configuration
  and limits of ``train/parity.py`` with ``w_rec`` 1, so G's update carries
  TrOCR's gradient through the fakes (TrOCR decodes teacher-forced, so its
  loss has no greedy ids to flip).  R is bit-unchanged on both sides;
- ``train_word --recognizer trocr`` for one epoch on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affganwriting_tpu.train.step as jstep
from affganwriting_tpu.models.recognizer import trocr as jtrocr
from affganwriting_torch.models.recognizer import trocr
from affganwriting_torch.train.parity import (
    DELTA_TOL,
    LOSS_TOL,
    STEP_BATCH,
    STEP_CONFIG,
    XG_TOL,
    delta_errors,
    delta_ok,
)
from affganwriting_torch.train.state import init_state
from affganwriting_torch.train.step import make_phased_train_step
from affganwriting_torch.utils.from_flax import (
    convert_module,
    trocr_core_from_flax,
    word_gan_from_flax,
)
from test_torch_support import (
    jax_word_gan_state,
    random_variables,
    save_tiny_trocr,
    small_jax_config,
    small_torch_config,
    tiny_hf_trocr,
    to_numpy_tree,
    word_batch,
)

torch.set_num_threads(2)   # tier-1 runs six xdist workers

T = 8            # output_max_len of the module tests
TROCR_STEP = dict(STEP_CONFIG, recognizer="trocr", trocr_preset="tiny",
                  rec_frozen=True, w_rec=1.0)


def _labels(rng, b: int, t: int) -> np.ndarray:
    ids = rng.integers(3, 55, size=(b, t))
    for i, n in enumerate(rng.integers(1, t - 2, size=b)):
        ids[i, n + 1] = 1
        ids[i, n + 2:] = 2
    ids[:, 0] = 0
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny recognizer, its random variables, the port's with them
    loaded, and inputs."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, size=(2, 64, 216, 1)).astype(np.float32)
    labels = _labels(rng, 2, T)
    jrec = jtrocr.TrOCRRecognizer(jtrocr.TrOCRArch.tiny(), output_max_len=T)
    variables = random_variables(jrec, img, labels, seed=5)
    port = trocr.TrOCRRecognizer(trocr.TrOCRArch.tiny(), T)
    port.load_state_dict(convert_module(to_numpy_tree(variables), port))
    return jrec, variables, port.eval(), img, labels


def test_tiny_logits_and_image_gradient_match_jax(tiny_pair):
    jrec, variables, port, img, labels = tiny_pair
    w = np.random.default_rng(1).normal(size=(2, T - 1, 55)).astype(
        np.float32)

    def f(x):
        return jnp.sum(jrec.apply(variables, x, labels)[0] * w)

    want = np.asarray(jrec.apply(variables, img, labels)[0])
    want_grad = np.asarray(jax.grad(f)(jnp.asarray(img)))
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got, none = port(x, torch.from_numpy(labels))
    assert none is None and got.dtype == torch.float32
    assert got.shape == want.shape == (2, T - 1, 55)
    (got * torch.from_numpy(w)).sum().backward()
    err = np.abs(got.detach().numpy() - want)
    assert (err <= 1e-4 * np.maximum(1.0, np.abs(want))).all(), err.max()
    masked = ~np.asarray(port.valid_mask)
    assert (want[..., masked] == trocr.TrOCRRecognizer.MASK_FILL).all()
    g = x.grad.permute(0, 2, 3, 1).numpy()
    scale = np.abs(want_grad).max()
    assert scale > 0
    print(f"tiny TrOCR vs JAX: logits max abs {err.max():.3g}, image "
          f"gradient max abs {np.abs(g - want_grad).max() / scale:.3g} of "
          "its largest entry")
    assert np.abs(g - want_grad).max() <= 1e-4 * scale, \
        (np.abs(g - want_grad).max(), scale)


def test_preprocess_and_its_gradient_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(-1.2, 1.2, size=(2, 64, 216, 1)).astype(np.float32)
    cot = rng.normal(size=(2, 384, 384, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jtrocr.preprocess_for_trocr(x, 384),
                        jnp.asarray(img))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = trocr.preprocess_for_trocr(x, 384)
    assert got.shape == (2, 3, 384, 384)
    got.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(),
                               want_grad, atol=1e-6, rtol=1e-6)


class _StubTokenizer:
    """A tokenizer with specials 7/8/9 where 'a' has two tokens and 'q'
    none."""

    bos_token_id, pad_token_id, eos_token_id = 7, 8, 9

    def __call__(self, ch, add_special_tokens=False):
        assert not add_special_tokens
        ids = {"a": [100, 101], "q": []}.get(ch, [200 + ord(ch)])
        return {"input_ids": ids}


@pytest.mark.parametrize("vocab_tro", [384, 50265, 100])
def test_char_token_tables_match_jax(vocab_tro):
    for got, want in zip(trocr.default_char_token_table(vocab_tro),
                         jtrocr.default_char_token_table(vocab_tro)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(trocr.table_from_tokenizer(_StubTokenizer()),
                         jtrocr.table_from_tokenizer(_StubTokenizer())):
        np.testing.assert_array_equal(got, want)


def _set_hf_eps(core: trocr.TrOCRCore) -> None:
    """HF's LayerNorm eps in the port's core: 1e-12 in the ViT, 1e-5 in
    the TrOCR decoder."""
    for name, m in core.named_modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = 1e-12 if name.startswith("encoder") else 1e-5


def test_importer_matches_jax_and_transformers():
    model = tiny_hf_trocr(seed=3)
    sd = model.state_dict()
    arch = trocr.TrOCRArch.tiny()
    got = trocr.import_torch_state_dict(sd, arch)
    want = trocr_core_from_flax(to_numpy_tree(jtrocr.import_torch_state_dict(
        sd, jtrocr.TrOCRArch.tiny())), arch)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k

    core = trocr.TrOCRCore(arch).eval()
    core.load_state_dict(got, strict=True)
    gen = torch.Generator().manual_seed(4)
    pixels = torch.randn(2, 3, 384, 384, generator=gen)
    ids = torch.randint(0, arch.vocab_tro, (2, 9), generator=gen)
    with torch.no_grad():
        ref = model(pixel_values=pixels, decoder_input_ids=ids).logits
        ours = core(pixels, ids)
        _set_hf_eps(core)
        ours_hf_eps = core(pixels, ids)
    eps_gap = float((ours - ref).abs().max())
    print(f"port vs transformers, max abs logit gap: {eps_gap:.3g} "
          f"(flax eps); {float((ours_hf_eps - ref).abs().max()):.3g} "
          f"(HF's eps)")
    assert eps_gap <= 1e-3, eps_gap
    assert float((ours_hf_eps - ref).abs().max()) <= 2e-5


def test_load_pretrained_matches_jax(tmp_path):
    arch_j, arch = jtrocr.TrOCRArch.tiny(), trocr.TrOCRArch.tiny()
    assert trocr.load_pretrained(str(tmp_path / "missing"), arch) is None
    for sub, with_tokenizer in (("plain", False), ("tok", True)):
        path = str(tmp_path / sub)
        model = save_tiny_trocr(path, seed=6, processor=with_tokenizer)
        state, mv, vm = trocr.load_pretrained(path, arch)
        jparams, jmv, jvm = jtrocr.load_pretrained(path, arch_j)
        want = trocr_core_from_flax(to_numpy_tree(jparams), arch)
        assert all(torch.equal(state[k], want[k]) for k in want)
        assert state.keys() == want.keys()
        np.testing.assert_array_equal(mv, jmv)
        np.testing.assert_array_equal(vm, jvm)
        default = trocr.default_char_token_table(arch.vocab_tro)
        assert np.array_equal(mv, default[0]) != with_tokenizer
        assert torch.equal(
            state["decoder.output_projection.weight"],
            model.state_dict()["decoder.output_projection.weight"])
    assert os.path.isfile(tmp_path / "tok" / "vocab.json")


@pytest.fixture(scope="module")
def frozen_runs():
    """One merged step of each package with the tiny TrOCR as frozen R."""
    jcfg = small_jax_config(**TROCR_STEP)
    tcfg = small_torch_config(**TROCR_STEP)
    batch = word_batch(tcfg, STEP_BATCH, 11)
    state, models = jax_word_gan_state(jcfg, batch)
    before = to_numpy_tree(state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_models", lambda cfg: models)
        step = jstep.make_phased_train_step(jcfg, merge_dg=True)
    new, metrics, extras = step(state, batch, jax.random.key(0))
    want = {"before": word_gan_from_flax(before, tcfg),
            "after": word_gan_from_flax(to_numpy_tree(new), tcfg),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "xg": np.asarray(extras["xg"])}
    port = init_state(tcfg, device="cpu", weights=want["before"])
    assert port.rec.opt is None
    assert not any(p.requires_grad for p in port.rec.model.parameters())
    port, pm, pe = make_phased_train_step(tcfg, merge_dg=True, device="cpu")(
        port, batch, torch.Generator().manual_seed(0))
    got = {"after": {n: getattr(port, n).model.state_dict()
                     for n in ("gen", "dis", "cla", "rec")},
           "metrics": {k: float(v) for k, v in pm.items()},
           "xg": pe["xg"].numpy()}
    return want, got


def test_frozen_trocr_step_matches_jax(frozen_runs):
    want, got = frozen_runs
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert np.isfinite(got["metrics"][k]), k
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * max(1.0, abs(w)), \
            (k, got["metrics"][k], w)
    assert want["metrics"]["l_rec"] > 0
    err = np.abs(got["xg"] - want["xg"]).max()
    assert err <= XG_TOL, err
    for name in ("gen", "dis", "cla"):
        l2, per_leaf = delta_errors(got["after"][name], want["after"][name],
                                    want["before"][name])
        worst = max(per_leaf, key=per_leaf.get)
        assert delta_ok(name, l2, per_leaf), (name, l2, worst,
                                              per_leaf[worst], DELTA_TOL)
    for k, v in want["before"]["rec"].items():
        assert torch.equal(want["after"]["rec"][k], v), k
        assert torch.equal(got["after"]["rec"][k], v), k


def test_train_word_trains_against_a_frozen_trocr(tmp_path, monkeypatch):
    """``train_word --recognizer trocr`` (tiny, the small config, one
    training epoch of two steps on the CPU, without the eval and the
    checkpoints ``fit`` adds): R is the frozen TrOCR, bit-unchanged, with
    no optimizer; G moved; the losses are finite."""
    import json

    from affganwriting_torch.cli import train_word
    from test_torch_support import TRAIN_SMALL

    monkeypatch.setattr(train_word, "default_config",
                        lambda: small_torch_config(**TRAIN_SMALL))
    import affganwriting_torch.utils.logging as logging

    monkeypatch.setattr(logging, "summary_writer", lambda logdir: None)
    trainer, _ = train_word.build_trainer([
        "--recognizer", "trocr", "--style-encoder", "resnet18",
        "--batch-size", "2", "--compute-dtype", "float32",
        "--max-writers", "4", "--eval-every", "10", "--restart-rss-gb", "0",
        "--logdir", str(tmp_path / "run"), "--device", "cpu"])
    cfg = trainer.config
    assert (cfg.recognizer, cfg.rec_frozen, cfg.trocr_preset) == \
        ("trocr", True, "tiny")
    assert isinstance(trainer.state.rec.model, trocr.TrOCRRecognizer)
    assert trainer.state.rec.opt is None
    rec0 = {k: v.clone() for k, v in trainer.state.rec.model.state_dict()
            .items()}
    gen0 = {k: v.clone() for k, v in trainer.state.gen.model.state_dict()
            .items()}
    trainer.train_epoch(0)
    assert trainer.state.step == 2
    rec1 = trainer.state.rec.model.state_dict()
    assert all(torch.equal(rec1[k], v) for k, v in rec0.items())
    gen1 = trainer.state.gen.model.state_dict()
    assert any(not torch.equal(gen1[k], v) for k, v in gen0.items())
    line = json.loads(open(tmp_path / "run" / "metrics.jsonl").readline())
    assert all(np.isfinite(v) for k, v in line.items() if k != "group")
