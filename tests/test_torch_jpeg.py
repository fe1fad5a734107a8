"""The port's JPEG decoder (gd3d_torch/data/jpeg.py) against Pillow, which
gd3d's eval decodes with: every baseline case must give PIL's
Image.open(f).convert("RGB") bytes exactly, and jpeg_size PIL's .size.
Progressive, CMYK and 4x1-sampled files are refused with a
ValueError that names the file.

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
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

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


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive"),
    ("cmyk", "4-component"),
    ("411", "sampling factors 4x1"),
])
def test_unsupported_files_are_refused(tmp_path, kind, match):
    img = np.random.RandomState(7).randint(0, 256, (16, 24, 3), np.uint8)
    path = tmp_path / f"{kind}.jpg"
    if kind == "progressive":
        Image.fromarray(img).save(path, "JPEG", progressive=True)
    elif kind == "cmyk":
        Image.fromarray(img).convert("CMYK").save(path, "JPEG")
    else:
        path.write_bytes(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                     0x411111])[1].tobytes())
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
        if name == "progressive.jpg":
            continue
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
    path = os.path.join(TESTDATA, "progressive.jpg")
    assert Image.open(path).info.get("progressive")
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(path)


if __name__ == "__main__":
    write_fixtures()
