"""The port's Lanczos and bicubic resizes (gd3d_torch/data/resample.py)
against Pillow's Image.resize(..., LANCZOS), which gd3d's eval resizes with,
and Image.resize(..., BICUBIC), which its training loaders use: the same
bytes, up and down, at the eval's and the loaders' sizes and at random ones."""
import numpy as np
import pytest
from PIL import Image

from gd3d_torch.data.resample import PRECISION_BITS, lanczos_coeffs, resize_bicubic, resize_lanczos


def _pil(img, size):
    return np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))


@pytest.mark.parametrize("hw,size", [
    ((480, 854), (848, 464)),   # a DAVIS frame to the tracking size
    ((375, 500), (640, 480)),   # PF-PASCAL canvases: landscape ...
    ((500, 375), (480, 640)),   # ... portrait ...
    ((333, 500), (640, 426)),   # ... and an odd height
    ((80, 100), (64, 51)),      # the CPU tests' tiny canvas
    ((96, 128), (96, 64)),      # the CPU tests' tiny frames
])
def test_eval_sizes_match_pil(hw, size):
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3), np.uint8)
    np.testing.assert_array_equal(resize_lanczos(img, size), _pil(img, size))


@pytest.mark.parametrize("seed", range(6))
def test_random_sizes_match_pil(seed):
    """Up, down and mixed, from 1 pixel on; width only and height only."""
    rng = np.random.RandomState(100 + seed)
    h, w = rng.randint(1, 200, 2)
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    for size in [tuple(rng.randint(1, 300, 2)), (int(w), int(rng.randint(1, 300))),
                 (int(rng.randint(1, 300)), int(h))]:
        np.testing.assert_array_equal(resize_lanczos(img, size), _pil(img, size))


def test_grayscale_and_identity_match_pil():
    img = np.random.RandomState(3).randint(0, 256, (37, 53), np.uint8)
    np.testing.assert_array_equal(resize_lanczos(img, (20, 71)), _pil(img, (20, 71)))
    same = resize_lanczos(img, (53, 37))
    np.testing.assert_array_equal(same, img)
    assert same is not img


def test_coefficients_are_normalized():
    """Each output's fixed-point weights sum to 2^22 within the rounding of
    its taps, and start inside the image."""
    for n_in, n_out in ((854, 848), (375, 640), (640, 97)):
        first, w = lanczos_coeffs(n_in, n_out)
        sums = w.sum(axis=1)
        assert np.all(np.abs(sums - (1 << PRECISION_BITS)) <= w.shape[1])
        assert first.min() >= 0 and first.max() < n_in


@pytest.mark.parametrize("hw,size", [
    ((1168, 1752), (512, 512)),  # ScanNet++'s _square_rgb
    ((1168, 1752), (518, 350)),  # load_images_vggt, crop
    ((341, 512), (512, 512)),
    ((200, 300), (512, 341)),  # load_image_mast3r upscaling
    ((37, 53), (20, 11)),
    ((9, 17), (518, 294)),
])
def test_bicubic_matches_pil(hw, size):
    img = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, size), want)
    # Image.resize's default filter is bicubic, as gd3d's _square_rgb relies on
    np.testing.assert_array_equal(resize_bicubic(img, size),
                                  np.asarray(Image.fromarray(img).resize(size)))


def test_a_resize_to_the_same_size_is_a_copy():
    img = np.random.RandomState(0).randint(0, 256, (512, 512, 3), dtype=np.uint8)
    out = resize_bicubic(img, (512, 512))
    assert out is not img
    np.testing.assert_array_equal(out, np.asarray(Image.fromarray(img).resize((512, 512))))
