"""The yardstick's arithmetic against hand sums at cell 1's shapes."""

import pytest

from benchmark.harness import work

CFG = {"img_height": 64, "img_width": 216, "style_dim": 512}


def test_decoder_shapes_at_128_words():
    s = work.decoder_shapes(CFG, 128)
    assert s["in_relu"] == [(128, 256, 16, 54), (128, 128, 32, 108)]
    assert s["phase_head"] == (128, 256, 32, 108)


@pytest.mark.parametrize("shape,nbytes", [
    ((128, 256, 16, 54), 2 * 2 * 128 * 256 * 16 * 54),      # 113,246,208
    ((128, 128, 32, 108), 2 * 2 * 128 * 128 * 32 * 108),    # 226,492,416
])
def test_in_relu_work(shape, nbytes):
    flops, b = work.in_relu_work(shape)
    assert flops == 0.0 and b == nbytes == 4 * shape[0] * shape[1] * \
        shape[2] * shape[3]


def test_phase_head_work():
    flops, b = work.phase_head_work((128, 256, 32, 108))
    pixels = 128 * 64 * 216                       # the image's pixels
    assert flops == 2 * 49 * 64 * pixels          # 11,098,128,384
    # phase tensor read, 7x7x64 weights and the bias read, image written
    assert b == 2 * (128 * 256 * 32 * 108 + 49 * 64 + 1 + pixels)


def test_roofline_share_takes_the_larger_bound():
    peaks = (3.35e12, 989e12)
    assert work.roofline_share(0.0, 3.35e9, 2e-3, peaks) == pytest.approx(50.0)
    assert work.roofline_share(989e9, 1.0, 1e-3, peaks) == pytest.approx(100.0)
