"""The port's augmentations (gd3d_torch/data/augment.py) against gd3d's
(gd3d/data/augment.py) and the cv2 calls they stand for, on the installed
OpenCV 5.0.0, exactly:

- COLOR_RGB2LAB, COLOR_LAB2RGB, COLOR_RGB2HSV over every 8-bit input and
  COLOR_HSV2RGB over every hue byte (0-255), saturation and value, at a
  row width of 256 and at widths 1-70 (OpenCV's vector loop and its scalar
  tail round HSV2RGB differently);
- GaussianBlur at k = 3, 5, 7 on odd sizes down to one row;
- CLAHE (createCLAHE(clip, (8, 8)).apply) at sizes divisible and not
  divisible by the tile grid, clip limits 1-4;
- getRotationMatrix2D, and warpAffine with INTER_LINEAR and INTER_NEAREST
  and a zero border;
- every gd3d augmentation at several seeds and odd sizes, with the caller's
  RandomState equal after the call.

The Lab round trip and CLAHE are bit-exact here, so no allowance is used.
"""
import os
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gd3d.data import augment as gaug  # noqa: E402
from gd3d_torch.data import augment as aug  # noqa: E402


def _all_triples(first):
    """(32 * 256, 256, 3) uint8: every (a, b, c) with a in first..first+31."""
    a, b, c = np.meshgrid(np.arange(first, first + 32), np.arange(256), np.arange(256),
                          indexing="ij")
    return np.stack([a, b, c], -1).reshape(-1, 256, 3).astype(np.uint8)


@pytest.mark.parametrize("first", range(0, 256, 32))
@pytest.mark.parametrize("code,fn", [
    (cv2.COLOR_RGB2LAB, aug.rgb2lab), (cv2.COLOR_LAB2RGB, aug.lab2rgb),
    (cv2.COLOR_RGB2HSV, aug.rgb2hsv), (cv2.COLOR_HSV2RGB, aug.hsv2rgb)],
    ids=["rgb2lab", "lab2rgb", "rgb2hsv", "hsv2rgb"])
def test_color_conversions_match_cv2_on_every_input(first, code, fn):
    img = _all_triples(first)
    np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, code))


@pytest.mark.parametrize("code,fn", [
    (cv2.COLOR_RGB2LAB, aug.rgb2lab), (cv2.COLOR_LAB2RGB, aug.lab2rgb),
    (cv2.COLOR_RGB2HSV, aug.rgb2hsv), (cv2.COLOR_HSV2RGB, aug.hsv2rgb)],
    ids=["rgb2lab", "lab2rgb", "rgb2hsv", "hsv2rgb"])
def test_color_conversions_match_cv2_at_every_row_width(code, fn):
    rng = np.random.RandomState(0)
    for w in list(range(1, 71)) + [97, 131, 255, 257, 515]:
        img = rng.randint(0, 256, (9, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, code), err_msg=f"width {w}")


SIZES = [(1, 5), (2, 9), (3, 3), (9, 17), (37, 53), (97, 131), (336, 512)]


def _image(h, w, seed, c=3):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, c) if c else (h, w)).astype(np.uint8)
    return cv2.GaussianBlur(img, (3, 3), 0) if min(h, w) > 2 else img


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("hw", SIZES)
def test_gaussian_blur_matches_cv2(k, hw):
    for c in (3, 0):
        img = _image(*hw, seed=k, c=c)
        np.testing.assert_array_equal(aug.gaussian_blur_cv(img, k),
                                      cv2.GaussianBlur(img, (k, k), 0))


@pytest.mark.parametrize("clip", [1.0, 2.37, 4.0])
@pytest.mark.parametrize("hw", [(8, 8), (9, 17), (37, 53), (64, 64), (100, 80), (336, 512),
                                (512, 512)])
def test_clahe_matches_cv2(clip, hw):
    img = _image(*hw, seed=int(clip * 10), c=0)
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(img)
    np.testing.assert_array_equal(aug.clahe_apply(img, clip), want)


def test_rotation_matrix_matches_cv2():
    rng = np.random.RandomState(1)
    for _ in range(50):
        center = (rng.randint(1, 600) / 2, rng.randint(1, 600) / 2)
        angle, scale = rng.uniform(-45, 45), 1 + rng.uniform(-0.25, 0.25)
        np.testing.assert_array_equal(aug.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("hw", [(9, 17), (37, 53), (64, 64), (512, 512)])
def test_warp_affine_matches_cv2(nearest, hw):
    h, w = hw
    rng = np.random.RandomState(h + nearest)
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for t in range(4):
        img = _image(h, w, seed=t, c=3 if t % 2 else 0)
        M = cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-45, 45),
                                    1 + rng.uniform(-0.25, 0.25))
        M[0, 2] += rng.uniform(-0.25, 0.25) * w
        M[1, 2] += rng.uniform(-0.25, 0.25) * h
        want = cv2.warpAffine(img, M, (w, h), flags=flags, borderMode=cv2.BORDER_CONSTANT,
                              borderValue=0)
        np.testing.assert_array_equal(aug.warp_affine(img, M, (w, h), nearest), want)


def _same_state(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


AUGS = ["gaussian_blur", "gauss_noise", "clahe", "brightness_contrast", "color_jitter",
        "color_augs_objaverse", "color_augs_scannetpp"]


@pytest.mark.parametrize("hw", [(9, 17), (97, 131), (512, 512)])
@pytest.mark.parametrize("name", AUGS)
def test_augmentations_match_gd3d(name, hw):
    for seed in range(6):
        img = _image(*hw, seed=seed)
        kwargs = [{}, {"blur_limit": (3, 7)}][seed % 2] if name == "gaussian_blur" else {}
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        want = getattr(gaug, name)(img.copy(), a, **kwargs)
        got = getattr(aug, name)(img.copy(), b, **kwargs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert _same_state(a, b)


@pytest.mark.parametrize("hw", [(9, 17), (97, 131), (512, 512)])
def test_shift_scale_rotate_matches_gd3d(hw):
    h, w = hw
    for seed in range(6):
        img = _image(h, w, seed=seed)
        rng = np.random.RandomState(seed + 100)
        kps = (rng.rand(64, 2) * [w, h]).astype(np.float32)
        mask = rng.rand(h, w) > 0.5
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        p = 0.5 if seed % 3 == 0 else 1.0
        want = gaug.shift_scale_rotate(img, kps, mask, a, p=p)
        got = aug.shift_scale_rotate(img, kps, mask, b, p=p)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        assert _same_state(a, b)
