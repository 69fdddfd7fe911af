"""The port's ``utils/native.py`` warps of one image (``elastic_native``,
``affine_native``) vs the JAX package's wrappers and the port's
``data/augment.py``.

Nothing in either package calls these two: these tests are their users.
Both wrappers run on the one library the port builds from
``native/preprocess.cpp`` (the JAX loader pointed at it, as
tests/test_torch_line_data.py does), so a bit-equal result holds the
bindings and the order in which each draws its displacement fields from
the caller's ``np.random.Generator``.  Skipped when ``g++`` cannot build
the library, as tests/test_native.py skips without it.
"""

import subprocess

import numpy as np
import pytest

import affganwriting_tpu.utils.native as jnative
from affganwriting_torch.data.augment import rotate, shear
from affganwriting_torch.utils import native


@pytest.fixture(scope="module")
def built():
    try:
        native.build(verbose=False)
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("g++ could not build native/preprocess.cpp")
    if not native.available():
        pytest.skip("the built library does not load")


@pytest.fixture
def jax_on_port_library(built, monkeypatch):
    monkeypatch.setattr(jnative, "_SO", str(native.SO))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.load() is not None


@pytest.mark.parametrize("seed", [0, 1])
def test_elastic_native_is_bit_equal_to_the_jax_wrapper(jax_on_port_library,
                                                        seed):
    img = np.random.default_rng(10 + seed).random((64, 216)) \
        .astype(np.float32)
    got = native.elastic_native(img, np.random.default_rng(seed), 300.0, 8.0)
    want = jnative.elastic_native(img, np.random.default_rng(seed), 300.0,
                                  8.0)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)


@pytest.mark.parametrize("degrees,factor", [(3.0, 0.0), (0.0, 0.2),
                                            (-5.0, -0.3)])
def test_affine_native_is_bit_equal_to_the_jax_wrapper(jax_on_port_library,
                                                       degrees, factor):
    img = np.random.default_rng(1).random((32, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        native.affine_native(img, degrees=degrees, shear=factor),
        jnative.affine_native(img, degrees=degrees, shear=factor))


def test_affine_native_matches_rotate_and_shear(built):
    """Within 1e-3 of the numpy warps, the JAX package's own limit
    (tests/test_native.py)."""
    img = np.random.default_rng(1).random((32, 64)).astype(np.float32)
    np.testing.assert_allclose(native.affine_native(img, degrees=3.0),
                               rotate(img, 3.0), atol=1e-3)
    np.testing.assert_allclose(native.affine_native(img, shear=0.2),
                               shear(img, 0.2), atol=1e-3)


def test_elastic_native_keeps_the_shape_and_is_deterministic(built):
    img = np.random.default_rng(2).random((64, 216)).astype(np.float32)
    out = native.elastic_native(img, np.random.default_rng(3), 300.0, 8.0)
    assert out.shape == img.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, native.elastic_native(img, np.random.default_rng(3), 300.0, 8.0))
    assert not np.array_equal(
        out, native.elastic_native(img, np.random.default_rng(4), 300.0, 8.0))
