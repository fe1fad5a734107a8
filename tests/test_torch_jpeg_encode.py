"""The port's JPEG encoder (gd3d_torch/data/jpeg_encode.py) against PIL's
`Image.save(f, "JPEG", quality=q)` on this repository's Pillow
(libjpeg-turbo): the same bytes, which PIL and the port's decoder read back
to the same pixels, at the qualities gd3d's preprocessors use (75, 80, 90,
95) and at the ends of the range, on RGB sizes that are not multiples of
16 (the MCU), on noise and on smooth content. Tolerance: none."""
import io

import numpy as np
import pytest
from PIL import Image

from gd3d_torch.data.jpeg import decode_jpeg
from gd3d_torch.data.jpeg_encode import encode_jpeg, quant_tables

SIZES = [(1, 1), (8, 8), (17, 23), (37, 61), (100, 120), (96, 128), (121, 97)]


def pil_jpeg(rgb: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def content(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3 + yy, yy * 5 + 40, (xx + yy) * 2], -1)
    return ((base + rng.randint(0, 6, (h, w, 3))) % 256).astype(np.uint8)


@pytest.mark.parametrize("quality", [75, 80, 90, 95])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_bytes_equal_pil(quality, hw, kind):
    rgb = content(kind, *hw, seed=hw[0] * 7 + quality)
    got, want = encode_jpeg(rgb, quality), pil_jpeg(rgb, quality)
    assert got == want
    pil_pixels = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
    np.testing.assert_array_equal(pil_pixels, np.asarray(Image.open(io.BytesIO(want))))
    np.testing.assert_array_equal(decode_jpeg(got), pil_pixels)


@pytest.mark.parametrize("quality", [1, 10, 25, 49, 50, 51, 100])
def test_quality_range_and_tables(quality):
    rgb = content("smooth", 45, 70, quality)
    data = encode_jpeg(rgb, quality)
    assert data == pil_jpeg(rgb, quality)
    q = Image.open(io.BytesIO(data)).quantization  # natural order
    for k, table in enumerate(quant_tables(quality)):
        assert list(table) == list(q[k])


def test_uniform_and_extreme_images():
    for value in (0, 255, 128):
        rgb = np.full((33, 47, 3), value, np.uint8)
        assert encode_jpeg(rgb, 90) == pil_jpeg(rgb, 90)
    rgb = np.zeros((40, 40, 3), np.uint8)
    rgb[::2, ::2] = 255  # the largest AC coefficients
    assert encode_jpeg(rgb, 100) == pil_jpeg(rgb, 100)


def test_refuses_what_it_does_not_encode():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
