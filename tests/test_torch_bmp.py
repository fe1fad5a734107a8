"""The port's BMP decoder (gd3d_torch/data/bmp.py) against Pillow, which gd3d
opens `.bmp` views with: files written by PIL, by cv2 and by a packer here
(every header size, 1/4/8-bit palettes, 5-5-5 and 5-6-5, 24 and 32 bits,
Pillow's bitfield layouts, RLE8 and RLE4 with end-of-line, delta and
absolute runs, top-down rows) give Pillow's mode, np.asarray and RGB (and
gd3d's _to_pil) bit for bit; what Pillow refuses raises a ValueError naming
the file."""
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_threads import one_torch_thread  # noqa: E402,F401
from gd3d.data import images as gimages  # noqa: E402
from gd3d_torch.data import bmp, images  # noqa: E402

H, W = 13, 21


def pack_bmp(rows, w, h, bits, hsize=40, compression=0, masks=None, palette=None,
             top_down=False, colors=None, offset=None):
    """A BMP of `rows` (bytes of the stored rows, file order, stride-padded
    here unless compressed)."""
    if compression in (1, 2):
        pix = bytes(rows)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        pix = b"".join(bytes(r) + bytes(stride - len(r)) for r in rows)
    pad = 3 if hsize == 12 else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(c[::-1]) + b"\x00" * (pad - 3) for c in np.asarray(palette, np.uint8))
    extra = b""
    if hsize == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, compression,
                          len(pix), 2835, 2835,
                          (len(palette) if palette is not None else 0) if colors is None
                          else colors, 0)
        if hsize > 40:
            m = tuple(masks or (0, 0, 0, 0)) + (0,) * 4
            hdr += struct.pack("<4I", *m[:4])[:hsize - 40]
            hdr += bytes(hsize - len(hdr))
        elif compression == 3:
            extra = struct.pack("<3I", *masks[:3])
    off = 14 + len(hdr) + len(extra) + len(pal) if offset is None else offset
    body = hdr + extra + pal
    return b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pix), 0, 0, off) + body + pix


def _img(seed, c=3):
    return np.random.RandomState(seed).randint(0, 256, (H, W, c), np.uint8)


def _bits_rows(idx, bits):
    h, w = idx.shape
    b = (idx[..., None] >> np.arange(bits - 1, -1, -1)) & 1
    return [bytes(r) for r in np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1)]


def _bottom_up(rows):
    return rows[::-1]


def _kinds():
    rgb = _img(0)
    rgba = _img(1, 4)
    idx4 = np.random.RandomState(2).randint(0, 16, (H, W)).astype(np.uint8)
    idx1 = np.random.RandomState(3).randint(0, 2, (H, W)).astype(np.uint8)
    idx8 = np.random.RandomState(4).randint(0, 200, (H, W)).astype(np.uint8)
    pal16 = np.random.RandomState(5).randint(0, 256, (16, 3))
    pal256 = np.random.RandomState(6).randint(0, 256, (256, 3))
    p565 = np.random.RandomState(7).randint(0, 1 << 16, (H, W)).astype("<u2")
    x32 = rgba.view("<u4")[..., 0]

    def u32_rows(v):
        return _bottom_up([r.astype("<u4").tobytes() for r in v])

    def fields(r, g, b, a=None):
        v = (rgba[..., 0].astype(np.uint64) << r) | (rgba[..., 1].astype(np.uint64) << g) | (
            rgba[..., 2].astype(np.uint64) << b)
        if a is not None:
            v |= rgba[..., 3].astype(np.uint64) << a
        return u32_rows(v.astype(np.uint32))

    rle8 = bytearray()
    for y in range(H):  # bottom row first: a run, an absolute run, then EOL
        rle8 += bytes([5, idx8[H - 1 - y, 0]])
        rle8 += bytes([0, 7]) + bytes(idx8[H - 1 - y, 5:12]) + b"\x00"  # padded to a word
        rle8 += bytes([W - 12, idx8[H - 1 - y, 12]]) + b"\x00\x00"
    rle8 = rle8[:-2] + b"\x00\x01"
    rle8_delta = bytearray(b"\x04\x07\x00\x02\x00\x00\x03\x01\x02\x09")  # Pillow's delta read
    rle8_delta += bytes([0, 3, 1, 2, 3, 0]) + b"\x00\x00" + bytes([W, 5, 0, 0]) * H + b"\x00\x01"
    rle4 = bytearray()
    for y in range(H):
        r = idx4[H - 1 - y]
        rle4 += bytes([6, (r[0] << 4) | r[1]])
        rle4 += bytes([0, 8]) + bytes((r[6 + 2 * i] << 4) | r[7 + 2 * i] for i in range(4))
        rle4 += bytes([0, 5]) + bytes([(r[14] << 4) | r[15], (r[16] << 4) | r[17], r[18] << 4])
        rle4 += b"\x00" + bytes([W - 19, (r[19] << 4) | r[20]]) + b"\x00\x00"
    grey_pal = np.repeat(np.arange(256)[:, None], 3, 1)
    return {
        "pil_rgb": lambda p: Image.fromarray(rgb).save(p),
        "pil_rgba_bgrx": lambda p: Image.fromarray(rgba).save(p),
        "pil_l": lambda p: Image.fromarray(rgb[..., 0]).save(p),
        "pil_1": lambda p: Image.fromarray(rgb[..., 0] > 100).save(p),
        "pil_p": lambda p: Image.fromarray(rgb).quantize(50).save(p),
        "cv2_bgr": lambda p: cv2.imwrite(p, rgb),
        "cv2_grey": lambda p: cv2.imwrite(p, rgb[..., 0]),
        "cv2_bgra": lambda p: cv2.imwrite(p, rgba),
        "core_8bit": pack_bmp(_bottom_up([bytes(r) for r in idx8]), W, H, 8, 12,
                              palette=pal256),
        "core_24bit": pack_bmp(_bottom_up([r[:, ::-1].tobytes() for r in rgb]), W, H, 24, 12),
        "info_4bit": pack_bmp(_bottom_up(_bits_rows(idx4, 4)), W, H, 4, palette=pal16),
        "info_4bit_colors0": pack_bmp(_bottom_up(_bits_rows(idx4, 4)), W, H, 4, palette=pal16,
                                      colors=0),
        "info_1bit_colour": pack_bmp(_bottom_up(_bits_rows(idx1, 1)), W, H, 1,
                                     palette=[(200, 10, 30), (5, 250, 90)]),
        "info_1bit_white_first": pack_bmp(_bottom_up(_bits_rows(idx1, 1)), W, H, 1,
                                          palette=[(255, 255, 255), (0, 0, 0)]),
        "info_8bit_short_palette": pack_bmp(_bottom_up([bytes(r) for r in idx8]), W, H, 8,
                                            palette=pal256[:150]),
        "info_8bit_grey_ramp": pack_bmp(_bottom_up([bytes(r) for r in idx8]), W, H, 8,
                                        palette=grey_pal),
        "info_8bit_offset_at_header": pack_bmp(_bottom_up([bytes(r) for r in idx8]), W, H, 8,
                                               palette=pal256, offset=54),
        "info_555": pack_bmp(_bottom_up([r.tobytes() for r in p565]), W, H, 16),
        "bitfields_565": pack_bmp(_bottom_up([r.tobytes() for r in p565]), W, H, 16,
                                  compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "bitfields_555_v4": pack_bmp(_bottom_up([r.tobytes() for r in p565]), W, H, 16, 108,
                                     compression=3, masks=(0x7C00, 0x3E0, 0x1F)),
        "bitfields_24": pack_bmp(_bottom_up([r[:, ::-1].tobytes() for r in rgb]), W, H, 24,
                                 compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
        "info_32_bgrx": pack_bmp(u32_rows(x32), W, H, 32),
        "v5_bgra": pack_bmp(fields(16, 8, 0, 24), W, H, 32, 124, compression=3,
                            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "v4_rgba": pack_bmp(fields(0, 8, 16, 24), W, H, 32, 108, compression=3,
                            masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
        "v3_abgr": pack_bmp(fields(24, 16, 8, 0), W, H, 32, 56, compression=3,
                            masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
        "v2_xbgr": pack_bmp(fields(24, 16, 8), W, H, 32, 52, compression=3,
                            masks=(0xFF000000, 0xFF0000, 0xFF00)),
        "info_bgxr": pack_bmp(fields(24, 0, 8), W, H, 32, compression=3,
                              masks=(0xFF000000, 0xFF00, 0xFF)),
        "v5_zero_masks": pack_bmp(u32_rows(x32), W, H, 32, 124, compression=3,
                                  masks=(0, 0, 0, 0)),
        "v5_bgar": pack_bmp(fields(24, 8, 0, 16), W, H, 32, 124, compression=3,
                            masks=(0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
        "top_down_24": pack_bmp([r[:, ::-1].tobytes() for r in rgb], W, H, 24, top_down=True),
        "top_down_4bit_v5": pack_bmp(_bits_rows(idx4, 4), W, H, 4, 124, palette=pal16,
                                     top_down=True),
        "rle8": pack_bmp(rle8, W, H, 8, compression=1, palette=pal256),
        "rle8_delta": pack_bmp(rle8_delta, W, H, 8, compression=1, palette=pal256),
        "rle8_grey": pack_bmp(rle8, W, H, 8, compression=1, palette=grey_pal),
        "rle4": pack_bmp(rle4, W, H, 4, compression=2, palette=pal16),
        "rle4_top_down": pack_bmp(rle4, W, H, 4, compression=2, palette=pal16, top_down=True),
    }


KINDS = _kinds()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("bmp")
    paths = {}
    for name, what in KINDS.items():
        paths[name] = str(d / f"{name}.bmp")
        if isinstance(what, bytes):
            with open(paths[name], "wb") as f:
                f.write(what)
        else:
            what(paths[name])
    return paths


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_matches_pil(written, kind):
    with Image.open(written[kind]) as im:
        mode, want, rgb = im.mode, np.asarray(im), np.asarray(im.convert("RGB"))
        size = im.size
    got = bmp.decode_bmp(written[kind])
    assert got.mode == mode
    assert got.pixels.shape == want.shape and got.pixels.dtype == want.dtype
    np.testing.assert_array_equal(got.pixels, want)
    np.testing.assert_array_equal(bmp.pil_rgb(got, composite=False), rgb)
    assert bmp.bmp_size(written[kind]) == size


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_open_rgb_matches_gd3d_to_pil(written, kind):
    np.testing.assert_array_equal(images.open_rgb(written[kind]),
                                  np.asarray(gimages._to_pil(written[kind])))


def _refused(tmp_path, data, match, pil_refuses=True):
    path = tmp_path / "x.bmp"
    path.write_bytes(data)
    if pil_refuses:
        with pytest.raises(Exception):
            Image.open(path).load()
    with pytest.raises(ValueError, match=match) as err:
        bmp.decode_bmp(path)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("case", ["bits", "header", "jpeg", "masks", "truncated", "magic"])
def test_unsupported_files_are_refused(tmp_path, case):
    rgb = _img(9)
    rows = _bottom_up([r[:, ::-1].tobytes() for r in rgb])
    data, match = {
        "bits": (pack_bmp(rows, W, H, 24).replace(struct.pack("<HH", 1, 24), struct.pack(
            "<HH", 1, 12), 1), "12-bit"),
        "header": (pack_bmp(rows, W, H, 24)[:14] + struct.pack("<I", 20) + bytes(40), "header"),
        "jpeg": (pack_bmp(rows, W, H, 24, compression=4), "JPEG"),
        "masks": (pack_bmp(rows, W, H, 32, 108, compression=3,
                           masks=(0xFF00, 0xFF0000, 0xFF, 0)), "bitfields layout"),
        "truncated": (pack_bmp(rows, W, H, 24)[:200], "truncated"),
        "magic": (b"BX" + pack_bmp(rows, W, H, 24)[2:], "not a BMP"),
    }[case]
    _refused(tmp_path, data, match)
