"""The port's PNG decoder (gd3d_torch/data/png.py) against cv2 and PIL, which
gd3d reads its Objaverse renders with: every kind of PNG, written here by
cv2, by PIL or by a small encoder that sets each row's filter, must give
exactly what cv2.imread gives in its four modes (IMREAD_COLOR,
IMREAD_GRAYSCALE, IMREAD_ANYDEPTH, IMREAD_UNCHANGED) and what gd3d's
_to_pil gives (PIL's RGB after exif_transpose, RGBA onto white). Adam7
interlacing and depths below 8 bits are refused with a ValueError that
names the file. The EXIF orientation reader and transpose are held to PIL's
on JPEG and PNG files with orientations 1-8.
"""
import io
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, ImageOps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gd3d.data import images as gimages  # noqa: E402
from gd3d_torch.data import exif, images, png  # noqa: E402

H, W = 23, 31
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "gray": cv2.IMREAD_GRAYSCALE,
         "color": cv2.IMREAD_COLOR, "anydepth": cv2.IMREAD_ANYDEPTH}


def _smooth(seed, c, top=255, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, top + 1, (H, W, c)).astype(np.float64)
    a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1) + np.roll(a, 1, (0, 1))) / 4
    return np.clip(a, 0, top).astype(dtype)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(samples, color_type, depth=8, filters=(0,), palette=None, trns=None,
               interlace=0):
    """A PNG of `samples` (H, W, C) uint8/uint16, row y filtered with
    filters[y % len(filters)] (the reference filter of the PNG spec, byte by
    byte)."""
    h, w, c = samples.shape
    raw = samples.astype(">u2").tobytes() if depth == 16 else samples.astype(np.uint8).tobytes()
    stride = w * c * depth // 8
    bpp = max(1, c * depth // 8)
    rows = [raw[y * stride:(y + 1) * stride] for y in range(h)]
    out = bytearray()
    prev = bytes(stride)
    for y, row in enumerate(rows):
        f = filters[y % len(filters)]
        enc = bytearray(stride)
        for x in range(stride):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            cc = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[f]
            enc[x] = (row[x] - pred) & 255
        out += bytes([f]) + enc
        prev = row

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                                       0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    return data + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def _pil_writer(mode, arr, **kw):
    def write(path):
        im = Image.fromarray(arr) if arr.dtype == np.uint16 else Image.fromarray(arr, mode)
        assert im.mode == mode
        im.save(path, **kw)
    return write


def _cv2_writer(arr):
    def write(path):
        cv2.imwrite(path, arr, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    return write


def _raw_writer(*args, **kw):
    def write(path):
        with open(path, "wb") as f:
            f.write(encode_png(*args, **kw))
    return write


def _kinds():
    rgba8 = _smooth(0, 4)
    rgba16 = _smooth(1, 4, 65535, np.uint16)
    alpha = rgba8[..., 3].copy()
    alpha[0, :4], alpha[1, :4] = 0, 255
    rgba_var = np.concatenate([rgba8[..., :3], alpha[..., None]], -1)
    low16 = np.random.RandomState(2).randint(0, 600, (H, W)).astype(np.uint16)
    pal_img = Image.fromarray(rgba8[..., :3]).quantize(40)
    palette = np.random.RandomState(3).randint(0, 256, (20, 3))
    idx = np.random.RandomState(4).randint(0, 24, (H, W, 1)).astype(np.uint8)  # past the palette too
    key = rgba8[..., :3].copy()
    key[:3, :3] = (10, 20, 30)
    all_filters = (0, 1, 2, 3, 4)
    return {
        "cv2_gray8": _cv2_writer(rgba8[..., 0]),
        "cv2_gray16": _cv2_writer(rgba16[..., 0]),
        "cv2_rgb8": _cv2_writer(rgba8[..., :3]),
        "cv2_rgb16": _cv2_writer(rgba16[..., :3]),
        "cv2_rgba8": _cv2_writer(rgba8),
        "cv2_rgba16": _cv2_writer(rgba16),
        "pil_l": _pil_writer("L", rgba8[..., 0]),
        "pil_la": _pil_writer("LA", rgba8[..., :2]),
        "pil_rgb": _pil_writer("RGB", rgba8[..., :3]),
        "pil_rgba": _pil_writer("RGBA", rgba_var),
        "pil_i16_low": _pil_writer("I;16", low16),
        "pil_palette": lambda p: pal_img.save(p),
        "pil_palette_trns": lambda p: pal_img.save(p, transparency=3),
        "pil_rgb_key": _pil_writer("RGB", key, transparency=(10, 20, 30)),
        "pil_l_trns": _pil_writer("L", rgba8[..., 0], transparency=7),
        "raw_la16": _raw_writer(rgba16[..., :2], 4, 16, all_filters),
        "raw_gray16_paeth": _raw_writer(rgba16[..., :1], 0, 16, (4,)),
        "raw_rgb8_each_filter": _raw_writer(rgba8[..., :3], 2, 8, all_filters),
        "raw_rgba8_average": _raw_writer(rgba_var, 6, 8, (3, 4)),
        "raw_rgba16_each_filter": _raw_writer(rgba16, 6, 16, all_filters[::-1]),
        "raw_rgb16_key": _raw_writer(rgba16[..., :3], 2, 16, (1, 3),
                                     trns=rgba16[0, 0, :3].astype(">u2").tobytes()),
        "raw_palette_short_trns": _raw_writer(idx, 3, 8, all_filters, palette=palette,
                                              trns=bytes([0, 128, 255, 7])),
        "raw_gray8_up": _raw_writer(rgba8[..., :1], 0, 8, (2,)),
    }


KINDS = _kinds()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    paths = {}
    for name, write in KINDS.items():
        paths[name] = str(d / f"{name}.png")
        write(paths[name])
    return paths


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_imread_matches_cv2(written, kind, mode):
    want = cv2.imread(written[kind], MODES[mode])
    got = png.imread(written[kind], MODES[mode])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_open_rgb_matches_gd3d_to_pil(written, kind):
    want = np.asarray(gimages._to_pil(written[kind]))
    got = images.open_rgb(written[kind])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wavefront_equals_row_by_row():
    """Average and Paeth rows take the anti-diagonal wavefront; None, Sub and
    Up rows alone the row loop: both reconstruct the same bytes."""
    rgb = _smooth(5, 3)
    for filters in ((0, 1, 2), (3,), (4,), (0, 1, 2, 3, 4)):
        dec = png.decode_png(encode_png(rgb, 2, 8, filters))
        np.testing.assert_array_equal(dec.samples, rgb)


@pytest.mark.parametrize("what,kw,match", [
    ("interlaced", dict(interlace=1), "interlaced"),
    ("4-bit", dict(depth=4), "4-bit"),
])
def test_unsupported_files_are_refused(tmp_path, what, kw, match):
    path = tmp_path / f"{what}.png"
    grey = _smooth(6, 1)
    if kw.get("depth") == 4:
        data = encode_png(grey[:, :16] >> 4, 0, 8)
        data = data.replace(struct.pack(">IIBB", 16, H, 8, 0), struct.pack(">IIBB", 16, H, 4, 0))
    else:
        data = encode_png(grey, 0, 8, **kw)
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        png.decode_png(path)
    assert str(path) in str(err.value)


def test_pil_low_bit_depth_palette_is_refused(tmp_path):
    """PIL writes a palette of 16 colours or fewer with 4 bits an index."""
    path = tmp_path / "pal4.png"
    Image.fromarray(_smooth(7, 3)).quantize(8).save(path)
    with pytest.raises(ValueError, match="4-bit"):
        png.imread(path)


def _exif_bytes(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_pil(tmp_path, fmt, orientation):
    path = tmp_path / f"o{orientation}.{fmt.lower()}"
    Image.fromarray(_smooth(8, 3)).save(path, fmt, exif=_exif_bytes(orientation))
    data = path.read_bytes()
    assert images.file_orientation(data) == orientation
    want = np.asarray(ImageOps.exif_transpose(Image.open(path)).convert("RGB"))
    got = images.open_rgb(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if fmt == "PNG":  # cv2 turns it upright too, in all modes but IMREAD_UNCHANGED
        for flags in MODES.values():
            np.testing.assert_array_equal(png.imread(path, flags), cv2.imread(str(path), flags))


def test_exif_orientation_without_a_tag_or_block():
    assert exif.orientation(None) == 1
    assert exif.orientation(b"II*\x00\x08\x00\x00\x00\x00\x00") == 1  # an empty IFD0
    assert exif.orientation(b"garbage") == 1
    big_endian = b"MM\x00*\x00\x00\x00\x08\x00\x01" + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0)
    assert exif.orientation(big_endian) == 6
    buf = io.BytesIO()
    Image.fromarray(_smooth(9, 3)).save(buf, "JPEG")
    assert exif.jpeg_exif(buf.getvalue()) is None
