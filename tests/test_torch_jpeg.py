"""The port's JPEG decoder (gd3d_torch/data/jpeg.py) against Pillow, which
gd3d's eval decodes with: every baseline, progressive, CMYK / YCCK and
4:1:1 / 4:1:0 case must give PIL's Image.open(f).convert("RGB") bytes
exactly, and jpeg_size PIL's .size. Arithmetic-coded, lossless and
block-smoothed files decode too (tests/test_torch_jpeg_arith.py holds them
in full); what PIL refuses as well (12 bits, fractional sampling,
hierarchical and arithmetic-coded lossless files) raises a ValueError that
names the file.

The committed fixtures under gd3d_torch/eval/testdata/ (decoded on the card
by chip_smoke.py's eval phase) are checked here against the digests
written beside them: PIL's decode and Lanczos resizes must still give those
digests, and so must the port. `python tests/test_torch_jpeg.py` writes the
fixtures and their digests anew.
"""
import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gd3d_torch.data import jpeg_encode as E  # noqa: E402
from gd3d_torch.data.jpeg import decode_jpeg, jpeg_size  # noqa: E402
from gd3d_torch.data.resample import resize_lanczos  # noqa: E402

TESTDATA = os.path.join(ROOT, "gd3d_torch", "eval", "testdata")


def texture(h, w, seed, noise=12.0):
    """A smooth multi-scale colour texture with some noise: trackable, and
    small once compressed."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3))
    for cell, amp in ((96, 70.0), (24, 40.0), (6, 20.0)):
        low = rng.randn(h // cell + 2, w // cell + 2, 3)
        ys = np.arange(h) / cell
        xs = np.arange(w) / cell
        y0, x0 = ys.astype(int), xs.astype(int)
        ty, tx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        img += amp * ((low[y0][:, x0] * (1 - tx) + low[y0][:, x0 + 1] * tx) * (1 - ty)
                      + (low[y0 + 1][:, x0] * (1 - tx) + low[y0 + 1][:, x0 + 1] * tx) * ty)
    img += rng.randn(h, w, 3) * noise
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(data):
    got, want = decode_jpeg(data), _pil(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert jpeg_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_subsampling_and_quality_match_pil(subsampling, quality):
    """4:4:4, 4:2:2, 4:2:0 at three qualities, on noise (every coefficient
    live) at an odd size, 17 x 9."""
    rng = np.random.RandomState(subsampling * 7 + quality)
    _check(_jpeg(rng.randint(0, 256, (9, 17, 3), np.uint8), subsampling=subsampling,
                 quality=quality))


@pytest.mark.parametrize("hw,kw", [
    ((1, 1), dict(subsampling=2)),
    ((2, 3), dict(subsampling=1)),
    ((479, 853), dict(subsampling=2, quality=90)),
    ((479, 853), dict(subsampling=0, quality=75)),
])
def test_sizes_match_pil(hw, kw):
    """One pixel and a two-sample chroma row (libjpeg-turbo's plain
    upsampler), and DAVIS's frame size less one on both sides."""
    _check(_jpeg(texture(*hw, seed=hw[0]), **kw))


@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (375, 500)])
def test_grayscale_matches_pil(hw):
    """One component, replicated to RGB as PIL's convert("RGB")."""
    _check(_jpeg(texture(*hw, seed=3)[..., 0]))


@pytest.mark.parametrize("kw", [
    dict(restart_marker_blocks=3),
    dict(restart_marker_rows=1, subsampling=2),
    dict(optimize=True),
    dict(optimize=True, subsampling=1, restart_marker_blocks=1),
])
def test_restart_markers_and_optimized_tables_match_pil(kw):
    _check(_jpeg(np.random.RandomState(5).randint(0, 256, (37, 53, 3), np.uint8), **kw))


@pytest.mark.parametrize("factor", [0x121111, 0x221111])
def test_vertical_subsampling_matches_pil(factor):
    """4:4:0 (h1v2 fancy upsampling), which Pillow cannot write; cv2 can."""
    img = np.random.RandomState(6).randint(0, 256, (37, 53, 3), np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                                         cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    _check(enc.tobytes())


def encode_sampled(rgb, factors, quality=80):
    """A baseline JPEG of `rgb` with the components' sampling factors
    ((h, v) for Y, Cb, Cr), chroma subsampled by taking every r-th sample:
    files of ratios no encoder here writes (4:1:0, 3:1, 4x2 against 2x1)."""
    H, W = rgb.shape[:2]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qy, qc = E.quant_tables(quality)
    grids = []
    for i, (plane, (h, v)) in enumerate(zip(E.rgb_to_ycc(rgb), factors)):
        sub = plane[::vmax // v, ::hmax // h]
        sub = np.pad(sub, ((0, my * 8 * v - sub.shape[0]), (0, mx * 8 * h - sub.shape[1])),
                     mode="edge")
        q = E.fdct_quantize(E._blocks(sub).reshape(-1, 8, 8), qc if i else qy)
        grids.append(q.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4).reshape(
            my, mx, v * h, 64))
    mcus = np.concatenate(grids, axis=2).reshape(-1, 64)
    per = np.concatenate([np.full(h * v, i) for i, (h, v) in enumerate(factors)])
    comp = np.tile(per, my * mx)
    scan = E.entropy_code(mcus, comp, np.minimum(comp, 1))
    dqt = b"".join(E._segment(0xDB, bytes([i]) + bytes(t[E.ZIGZAG].astype(np.uint8)))
                   for i, t in enumerate((qy, qc)))
    sof = E._segment(0xC0, struct.pack(">BHHB", 8, H, W, 3) + b"".join(
        bytes([i + 1, (h << 4) | v, min(i, 1)]) for i, (h, v) in enumerate(factors)))
    dht = (E._dht(0, 0, E.DC_LUMA) + E._dht(1, 0, E.AC_LUMA) + E._dht(0, 1, E.DC_CHROMA)
           + E._dht(1, 1, E.AC_CHROMA))
    sos = E._segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + dqt + sof + dht + sos + scan + b"\xff\xd9"


@pytest.mark.parametrize("hw,kw", [
    ((37, 53), dict()),
    ((37, 53), dict(subsampling=0, quality=95)),
    ((37, 53), dict(subsampling=1, optimize=True)),
    ((1, 1), dict()),
    ((2, 3), dict(subsampling=1)),
    ((64, 40), dict(restart_marker_blocks=3)),
    ((64, 40), dict(restart_marker_rows=1, optimize=True)),
    ((479, 853), dict(quality=90)),
])
def test_progressive_matches_pil(hw, kw):
    """libjpeg's progression script: DC first and refinement, spectral
    selection, AC first scans with EOB runs, AC refinement with correction
    bits, non-interleaved AC scans, restart intervals inside them, and
    optimised per-scan tables."""
    _check(_jpeg(texture(*hw, seed=hw[1]), progressive=True, **kw))


@pytest.mark.parametrize("hw", [(9, 17), (128, 96)])
def test_progressive_grayscale_matches_pil(hw):
    _check(_jpeg(texture(*hw, seed=4)[..., 0], progressive=True))


@pytest.mark.parametrize("flags", [
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111),
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    (cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
     cv2.IMWRITE_JPEG_OPTIMIZE, 1),
])
def test_cv2_files_match_pil(flags):
    """cv2's 4:1:1 (int_upsample's replication) and its progressive files."""
    img = texture(45, 77, seed=8)
    ok, enc = cv2.imencode(".jpg", img, list(flags) + [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    _check(enc.tobytes())


@pytest.mark.parametrize("factors", [
    ((4, 2), (1, 1), (1, 1)),
    ((3, 1), (1, 1), (1, 1)),
    ((4, 1), (2, 1), (1, 1)),
    ((1, 4), (1, 2), (1, 1)),
    ((1, 4), (1, 1), (1, 2)),
])
def test_other_sampling_ratios_match_pil(factors):
    """4:1:0, 3:1, and ratios of 2 between factors above 2 (libjpeg-turbo's
    fancy h2v2 / h1v2 there, int_upsample elsewhere)."""
    _check(encode_sampled(texture(43, 71, seed=9), factors))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("transform", [None, 0, 2])
def test_cmyk_and_ycck_match_pil(progressive, transform):
    """PIL's CMYK files (Adobe transform 0), the same samples read as YCCK
    (transform 2, jdcolor.c's ycck_cmyk_convert) and with no Adobe marker,
    all through PIL's CMYK;I inversion and cmyk2rgb."""
    buf = io.BytesIO()
    Image.fromarray(texture(33, 50, seed=10)).convert("CMYK").save(buf, "JPEG",
                                                                   progressive=progressive)
    data = buf.getvalue()
    i = data.index(b"Adobe")
    if transform is None:
        data = data[:i - 4] + data[i - 2 + ((data[i - 2] << 8) | data[i - 1]):]
        assert b"Adobe" not in data
    else:
        data = data[:i + 11] + bytes([transform]) + data[i + 12:]
    _check(data)


def _drop_last_scan(data):
    i = data.rindex(b"\xff\xda")
    return data[:i] + b"\xff\xd9"


@pytest.mark.parametrize("kind,match", [
    ("progressive", None),
    ("cmyk", None),
    ("411", None),
    ("sof9", None),
    ("sof3", None),
    ("12bit", "12-bit"),
    ("fractional", "fractional sampling"),
    ("smoothing", None),
    ("hierarchical", "hierarchical"),
    ("sof11", "arithmetic-coded lossless"),
])
def test_unsupported_files_are_refused(tmp_path, kind, match):
    """Progressive, CMYK, 4:1:1, arithmetic-coded (SOF9) and lossless (SOF3)
    files, and a progressive file whose last scan was dropped, which
    libjpeg-turbo block-smooths, decode to PIL's RGB (the arithmetic and
    lossless files from tests/torch_jpeg_writer.py: no tool here writes
    them); what stays refused raises naming the file, and PIL refuses it
    too: 12 bits, fractional sampling ratios, a hierarchical file (DHP and
    SOF5) and arithmetic-coded lossless (SOF11)."""
    import torch_jpeg_writer as W

    img = np.random.RandomState(7).randint(0, 256, (16, 24, 3), np.uint8)
    path = tmp_path / f"{kind}.jpg"
    base = _jpeg(img)
    if kind == "progressive":
        Image.fromarray(img).save(path, "JPEG", progressive=True)
    elif kind == "cmyk":
        Image.fromarray(img).convert("CMYK").save(path, "JPEG")
    elif kind == "411":
        path.write_bytes(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                     0x411111])[1].tobytes())
    elif kind == "sof9":
        path.write_bytes(W.write_dct(W.dct_frame(W.ycc(img), W.F420), arith=True))
    elif kind == "sof3":
        path.write_bytes(W.write_lossless(list(np.moveaxis(img, -1, 0)), psv=4))
    elif kind == "12bit":
        i = base.index(b"\xff\xc0")
        path.write_bytes(base[:i + 4] + b"\x0c" + base[i + 5:])
    elif kind == "fractional":
        i = base.index(b"\xff\xc0") + 11  # Y 2x2 -> 3x2, Cb 1x1 -> 2x1
        path.write_bytes(base[:i] + b"\x32" + base[i + 1:i + 3] + b"\x21" + base[i + 4:])
    elif kind == "hierarchical":
        path.write_bytes(W.hierarchical_probe(img))
    elif kind == "sof11":
        path.write_bytes(W.sof11_probe(img))
    else:
        full = _jpeg(texture(32, 40, seed=2), progressive=True)
        path.write_bytes(_drop_last_scan(full))
    if match is None:  # held to PIL, not refused
        data = path.read_bytes()
        np.testing.assert_array_equal(decode_jpeg(data), _pil(data),
                                      err_msg=f"{kind}: decoded, but not to PIL's RGB")
        assert jpeg_size(data) == Image.open(io.BytesIO(data)).size
        return
    with pytest.raises(Exception):
        Image.open(path).load()
    with pytest.raises(ValueError, match=match) as err:
        decode_jpeg(path)
    assert str(path) in str(err.value)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")


def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _resize_targets(shape):
    """The eval's resize of an image of this shape: a DAVIS frame to
    848 x 464, a PF-PASCAL image's long side to 640."""
    h, w = shape[:2]
    if (h, w) == (480, 854):
        return [(848, 464)]
    if h <= w:
        return [(640, int(np.around(640 * h / w)))]
    return [(int(np.around(640 * w / h)), 640)]


def write_fixtures():
    """The JPEG fixtures of chip_smoke.py's eval phase and PIL's digests:
    four 854 x 480 4:2:0 frames, crops of one texture shifted by the
    (dx, dy) of frame_shifts; 500 x 375 files at 4:4:4, 4:2:2, grayscale, with restart
    markers and with optimised Huffman tables; one progressive file."""
    os.makedirs(TESTDATA, exist_ok=True)
    big = texture(480 + 64, 854 + 64, seed=11, noise=3.0)
    shifts = [(0, 0), (6, 3), (13, 7), (21, 10)]
    files = {}
    for i, (dx, dy) in enumerate(shifts):
        files[f"frame_{i}.jpg"] = _jpeg(big[dy: dy + 480, dx: dx + 854], quality=85,
                                        subsampling=2)
    pascal = texture(375, 500, seed=12, noise=3.0)
    files["pascal_444.jpg"] = _jpeg(pascal, quality=85, subsampling=0)
    files["pascal_422.jpg"] = _jpeg(pascal[:, ::-1].copy(), quality=85, subsampling=1)
    files["pascal_gray.jpg"] = _jpeg(pascal[..., 1].copy(), quality=85)
    files["pascal_restart.jpg"] = _jpeg(pascal[::-1].copy(), quality=85, subsampling=2,
                                        restart_marker_blocks=5)
    files["pascal_optimized.jpg"] = _jpeg(texture(375, 500, seed=13, noise=3.0), quality=85,
                                          subsampling=2, optimize=True)
    files["progressive.jpg"] = _jpeg(pascal[:48, :64].copy(), progressive=True)
    digests = {"frame_shifts": shifts, "files": {}}
    for name, data in sorted(files.items()):
        with open(os.path.join(TESTDATA, name), "wb") as f:
            f.write(data)
        img = Image.open(io.BytesIO(data)).convert("RGB")
        arr = np.asarray(img)
        digests["files"][name] = {
            "shape": list(arr.shape), "rgb": _sha(arr),
            "lanczos": {f"{w}x{h}": _sha(np.asarray(img.resize((w, h), Image.LANCZOS)))
                        for w, h in _resize_targets(arr.shape)}}
    with open(os.path.join(TESTDATA, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


def _digests():
    with open(os.path.join(TESTDATA, "digests.json")) as f:
        return json.load(f)["files"]


@pytest.mark.parametrize("name", sorted(_digests()))
def test_committed_fixtures_match_their_pil_digests(name):
    """PIL still gives the committed digests, and the port gives them too."""
    entry = _digests()[name]
    path = os.path.join(TESTDATA, name)
    img = Image.open(path).convert("RGB")
    assert _sha(np.asarray(img)) == entry["rgb"]
    got = decode_jpeg(path)
    assert list(got.shape) == entry["shape"] and _sha(got) == entry["rgb"]
    for size, digest in entry["lanczos"].items():
        w, h = map(int, size.split("x"))
        assert _sha(np.asarray(img.resize((w, h), Image.LANCZOS))) == digest
        assert _sha(resize_lanczos(got, (w, h))) == digest
    assert jpeg_size(path) == Image.open(path).size


def test_committed_progressive_fixture_is_refused():
    """The committed progressive file, which chip_smoke.py's eval phase once
    expected refused, now decodes to PIL's RGB and its committed digest."""
    path = os.path.join(TESTDATA, "progressive.jpg")
    assert Image.open(path).info.get("progressive")
    got = decode_jpeg(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")),
                                  err_msg="decoded, but not to PIL's RGB")
    assert _sha(got) == _digests()["progressive.jpg"]["rgb"], "decoded, but not to its digest"


if __name__ == "__main__":
    write_fixtures()
