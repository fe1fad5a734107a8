"""The port's OpenEXR reader (gd3d_torch/data/exr.py) against known values:
cv2 here has no EXR codec, so tests/exr_writer.py (numpy, OpenEXR's
compressors) writes seeded float32, float16 and uint32 arrays in every
supported compression, and the decoded arrays must equal them exactly
(float16 widened, as cv2.imread(f, IMREAD_ANYDEPTH) widens it). Each
compressed case is checked to hold compressed blocks, so the decoder's
path is the one under test. What stays unsupported raises a ValueError
naming the file and the feature."""
import os
import struct
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_threads import one_torch_thread  # noqa: E402,F401
from exr_writer import CODES, write_exr  # noqa: E402
from gd3d_torch.data import exr  # noqa: E402

COMPRESSIONS = ["NONE", "RLE", "ZIPS", "ZIP", "PIZ"]


def depth_map(h, w, dtype, seed):
    """A smooth depth map in 1/64 units (few distinct values, so every
    compression shrinks it), with a hole of zeros."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(seed)
    d = 2.0 + np.sin(yy / (5.0 + seed)) + np.cos(xx / 7.0) + 0.05 * rng.rand(h, w)
    d = np.round(d * 64) / 64
    d[h // 3: h // 2, w // 4: w // 3] = 0
    return d.astype(dtype)


def compressed_blocks(path, itemsize):
    data = open(path, "rb").read()
    attrs, pos = exr._header(data, str(path))
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    h, w = y1 - y0 + 1, x1 - x0 + 1
    lines = exr.LINES[comp]
    n = 0
    for off in np.frombuffer(data, "<u8", -(-h // lines), pos).tolist():
        y, size = struct.unpack_from("<ii", data, off)
        n += size < min(lines, h - (y - y0)) * w * itemsize
    return n


@pytest.mark.parametrize("shape", [(47, 61), (1, 1), (96, 33), (5, 200)])
@pytest.mark.parametrize("dtype", ["<f4", "<f2", "<u4"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_decode_equals_written_values(tmp_path, compression, dtype, shape):
    a = depth_map(*shape, np.float32, seed=shape[0] % 5)
    a = (a * 1000).astype(dtype) if dtype == "<u4" else a.astype(dtype)
    path = tmp_path / "d.exr"
    write_exr(path, a, compression)
    got = exr.read_exr(path)
    assert got.dtype == np.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got, a.astype(np.float32))
    if compression != "NONE" and shape[0] * shape[1] > 1000:
        assert compressed_blocks(path, np.dtype(dtype).itemsize) > 0


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_random_values_line_order_and_window(tmp_path, compression):
    """Noise (blocks stored raw where they do not shrink), infinities and
    NaNs, decreasing line order and a data window off the origin."""
    rng = np.random.RandomState(3)
    a = rng.randn(70, 45).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = np.inf, -np.inf, np.nan
    path = tmp_path / "n.exr"
    write_exr(path, a, compression, line_order=1, origin=(-4, 9))
    np.testing.assert_array_equal(exr.read_exr(path), a)


@pytest.mark.parametrize("values", ["few", "runs", "wide"])
def test_piz_wavelet_and_huffman_paths(tmp_path, values):
    """PIZ's 14-bit wavelet (under 2^14 distinct values) with Huffman runs,
    and its 16-bit wavelet (17000 distinct float16 values in one block, the
    rest zeros, so that the block still shrinks)."""
    rng = np.random.RandomState(4)
    if values == "few":
        a = np.round(rng.rand(64, 90) * 4).astype(np.float32)
    elif values == "runs":
        a = np.zeros((40, 40), np.float16)
        a[10:20] = 3.5
    else:
        a = np.zeros((32, 1100), np.float16)
        a.reshape(-1)[:17000] = rng.permutation(np.arange(0x0400, 0x0400 + 17000,
                                                          dtype=np.uint16)).view(np.float16)
    path = tmp_path / "p.exr"
    write_exr(path, a, "PIZ")
    assert compressed_blocks(path, a.dtype.itemsize) > 0
    np.testing.assert_array_equal(exr.read_exr(path), a.astype(np.float32))


@pytest.mark.parametrize("mx", [100, 40000])
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (7, 1), (13, 22), (32, 17), (64, 64)])
def test_wavelet_inverts_openexr_encoder(shape, mx):
    """wav2_decode undoes OpenEXR's wav2Encode (tests/exr_writer.py) on
    every plane shape, through the 14-bit (mx < 2^14) and 16-bit paths."""
    from exr_writer import wav2_encode

    p = np.random.RandomState(shape[0]).randint(0, mx, shape).astype(np.uint16)
    q = p.copy()
    wav2_encode(q, mx)
    exr.wav2_decode(q, mx)
    np.testing.assert_array_equal(q, p)


@pytest.mark.parametrize("what,match", [
    ("two_channels", "2 channels"),
    ("channel_R", "channel 'R'"),
    ("tiled", "tiled"),
    ("multipart", "multi-part"),
    ("PXR24", "PXR24"),
    ("B44", "B44"),
    ("DWAA", "DWAA"),
    ("not_exr", "not an OpenEXR"),
])
def test_unsupported_files_are_refused(tmp_path, what, match):
    path = tmp_path / "r.exr"
    a = depth_map(20, 30, np.float32, 0)
    if what in ("PXR24", "B44", "DWAA"):
        write_exr(path, a, "NONE")
        data = path.read_bytes()
        i = data.index(b"compression\x00compression\x00") + 28
        path.write_bytes(data[:i] + bytes([CODES[what]]) + data[i + 1:])
    elif what == "two_channels":
        write_exr(path, a, "ZIP", extra_channels=("Z",))
    elif what == "channel_R":
        write_exr(path, a, "ZIP", channel="R")
    elif what in ("tiled", "multipart"):
        write_exr(path, a, "NONE")
        data = path.read_bytes()
        flag = 0x200 if what == "tiled" else 0x1000
        path.write_bytes(data[:4] + struct.pack("<I", 2 | flag) + data[8:])
    else:
        path.write_bytes(b"\x89PNG" + bytes(40))
    with pytest.raises(ValueError, match=match) as err:
        exr.read_exr(path)
    assert str(path) in str(err.value)
