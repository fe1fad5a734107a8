"""cv2.resize of uint8 and float32 images (gd3d_torch/data/resample.py::
resize_cv and resize_linear_f32) against cv2.resize itself, and
StereoAugmentor(scale_interp_nearest=False) against gd3d's, on the CPU.

Held bit for bit: INTER_LINEAR of float32 images of 1, 3 and 4 channels at
the caller's scale (up and down, odd sizes, one axis or both, halving
included; exact ratios such as 2.0 go by size, as in OpenCV), of 1-channel
float32 images at the caller's size (up and down; 3 and 4 channels where
no side enlarges), and the halving (fx = fy = 0.5,
INTER_AREA in OpenCV) of uint8 images of every channel count and of
2-channel float32 ones, odd sizes with their partial last block included.
What the module refuses (sides under 4 samples in the float32 routes,
enlargements of 3- and 4-channel images by size) raises by name.
"""
import cv2
import numpy as np
import pytest

import gd3d.data.flowio as J
import gd3d_torch.data.flowio as T
from gd3d_torch.data.resample import resize_cv, resize_linear_f32


def _image(rng, h, w, cn, dtype):
    shape = (h, w) if cn == 1 else (h, w, cn)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return (rng.randn(*shape) * 10).astype(np.float32)


@pytest.mark.parametrize("cn", [1, 3, 4])
def test_float32_linear_by_scale_matches_cv2(cn):
    rng = np.random.RandomState(cn)
    sizes = [(4, 4), (5, 7), (33, 47), (96, 61), (120, 181)]
    scales = [(1.3, 1.0), (0.51, 0.73), (3.3, 2.1), (0.5, 0.5), (2.0, 2.0), (0.25, 1.0),
              (1.0, 1.7), (4.9, 0.9)]
    scales += [(2.0 ** rng.uniform(-1.5, 1.5), 2.0 ** rng.uniform(-1.5, 1.5)) for _ in range(6)]
    checked = 0
    for h, w in sizes:
        img = _image(rng, h, w, cn, np.float32)
        for fx, fy in scales:
            dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
            if min(dw, dh) < 4:
                continue
            want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
            if cn > 1 and dw / w == fx and dh / h == fy and (dw > w or dh > h):
                # an exact ratio goes by size (IPP), which enlarges 3- and
                # 4-channel images with border code not reproduced
                with pytest.raises(ValueError, match="not reproduced"):
                    resize_cv(img, fx, fy)
                continue
            got = resize_cv(img, fx, fy)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {fx} {fy}")
            checked += 1
    assert checked > 50


def test_float32_linear_by_size_matches_cv2():
    """1 channel at any size (vis_attn_map's upsampling by the patch size
    among them); 3 and 4 channels downsampled."""
    rng = np.random.RandomState(7)
    cases = [(1, (14, 14), (224, 224)), (1, (21, 32), (336, 512)), (1, (6, 8), (96, 128)),
             (1, (16, 24), (72, 24)), (1, (37, 53), (19, 80)), (1, (9, 75), (331, 27)),
             (3, (40, 62), (31, 20)), (4, (33, 47), (13, 30)), (3, (50, 50), (50, 17))]
    cases += [(1, tuple(rng.randint(4, 40, 2)), tuple(rng.randint(4, 200, 2)))
              for _ in range(8)]
    for cn, (h, w), (dw, dh) in cases:
        img = _image(rng, h, w, cn, np.float32)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_linear_f32(img, (dw, dh)), want,
                                      err_msg=f"{cn} {(h, w)} {(dw, dh)}")


@pytest.mark.parametrize("dtype,cn", [(np.uint8, 1), (np.uint8, 2), (np.uint8, 3),
                                      (np.uint8, 4), (np.float32, 2)])
def test_halving_matches_cv2_with_partial_blocks(dtype, cn):
    """fx = fy = 0.5, which OpenCV computes with INTER_AREA for these: sides
    of 4 k + 3 leave a last block of one row or column (the output side is
    rounded half to even), 4 k + 1 drop their last sample."""
    rng = np.random.RandomState(cn)
    for h, w in ((8, 10), (7, 9), (9, 7), (5, 5), (21, 22), (6, 11), (3, 7), (7, 3),
                 (11, 15), (2, 2), (64, 96)):
        img = _image(rng, h, w, cn, dtype)
        want = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_LINEAR)
        got = resize_cv(img, 0.5, 0.5)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=f"{(h, w)}")


def test_a_resize_to_the_same_size_is_a_copy():
    rng = np.random.RandomState(3)
    img = _image(rng, 34, 29, 3, np.float32)
    want = cv2.resize(img, None, fx=1.0023, fy=1.0, interpolation=cv2.INTER_LINEAR)
    got = resize_cv(img, 1.0023, 1.0)
    assert np.array_equal(got, want) and np.array_equal(got, img) and got is not img


def test_refusals_name_the_case():
    rng = np.random.RandomState(4)
    with pytest.raises(ValueError, match="not reproduced"):
        resize_cv(_image(rng, 3, 40, 1, np.float32), 2.0, 2.0)
    with pytest.raises(ValueError, match="not reproduced"):
        resize_cv(_image(rng, 40, 40, 1, np.float32), 0.05, 1.0)  # 2 samples wide
    with pytest.raises(ValueError, match="not reproduced"):
        resize_linear_f32(_image(rng, 10, 10, 3, np.float32), (20, 10))
    with pytest.raises(ValueError, match="not reproduced"):
        resize_cv(rng.rand(10, 10), 2.0, 2.0)  # float64 goes through resize_linear_cv
    with pytest.raises(ValueError, match="float32 images of 1, 3 or 4"):
        resize_linear_f32(_image(rng, 10, 10, 2, np.float32), (5, 5))


@pytest.mark.parametrize("seed", range(6))
def test_stereo_augmentor_with_linear_disparity_matches_gd3d(seed):
    """StereoAugmentor(scale_interp_nearest=False): the disparity resized
    with INTER_LINEAR (1-channel float32); SceneFlow-sized frames and small
    ones, x-only and both axes; the same arrays and the same RandomState
    afterwards."""
    rng = np.random.RandomState(300 + seed)
    h, w = (540, 960) if seed % 2 else (120, 180)
    img1, img2 = (rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(2))
    disp = (rng.rand(h, w) * 60).astype(np.float32)
    kw = dict(scale_interp_nearest=False, scale_xonly=seed < 3, scale_prob=1.0 if seed else 0.0)
    got = T.StereoAugmentor((256, 320) if h > 200 else (64, 96),
                            rng=np.random.RandomState(seed), **kw)
    want = J.StereoAugmentor((256, 320) if h > 200 else (64, 96),
                             rng=np.random.RandomState(seed), **kw)
    for g, x in zip(got(img1, img2, disp), want(img1, img2, disp)):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert got.rng.randint(1 << 30) == want.rng.randint(1 << 30)


def test_chip_smoke_tail_digest_is_gd3ds():
    """chip_smoke.py's tail phase holds the port's StereoAugmentor on the
    card's host to TAIL_AUG_DIGEST (the card's machine has no cv2): here
    gd3d's augmentor gives that digest, and the port's the same; the
    disparity is resized, not only cropped."""
    import chip_smoke as cs

    want = cs.tail_augment(J)
    assert cs.tail_digest(want) == cs.TAIL_AUG_DIGEST
    got = cs.tail_augment(T)
    assert cs.tail_digest(got) == cs.TAIL_AUG_DIGEST
    left, _, disp = cs.tail_stereo_pair()
    assert got[2].shape == cs.TAIL_CROP and not np.isin(got[2], disp).all()
