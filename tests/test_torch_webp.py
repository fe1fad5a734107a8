"""The port's WebP decoders (gd3d_torch/data/webp.py, vp8.py, vp8l.py)
against Pillow 12.1 on libwebp 1.6.0, which gd3d opens `.webp` views with:
lossy and lossless files at several sizes, qualities and methods, with and
without alpha, give Pillow's mode and np.asarray bit for bit, and gd3d's
_to_pil (EXIF orientation, RGBA onto white).

Pillow's encoder writes one token partition, the normal loop filter at
sharpness 0 and no filter deltas; a VP8 transcoder here (a boolean encoder,
RFC 6386 section 7.3) rewrites such a file's header and token partitions
to reach the simple filter, every sharpness, filter deltas, no filter and 2,
4 or 8 partitions, and Pillow's decode of the rewritten file is the
reference. Raw alpha with each of the three spatial filters is written here
too. Animated files give their frame 0 on the canvas, as Pillow's
WebPAnimDecoder renders it (files from PIL's save_all, and ANMF chunks
assembled here around still bitstreams, at offsets inside a larger
canvas)."""
import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_threads import one_torch_thread  # noqa: E402,F401
from gd3d.data import images as gimages  # noqa: E402
from gd3d_torch.data import images, vp8, webp  # noqa: E402


def texture(h, w, seed, c=3, noise=15.0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 60 * np.sin(yy / 7.0 + seed), 128 + 60 * np.cos(xx / 9.0),
                  128 + 50 * np.sin((xx + yy) / 11.0),
                  128 + 120 * np.sin(xx / 5.0) * np.cos(yy / 6.0)][:c], -1)
    return np.clip(a + rng.randn(h, w, c) * noise, 0, 255).astype(np.uint8)


def save(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def check(data):
    with Image.open(io.BytesIO(data)) as im:
        mode, want = im.mode, np.asarray(im)
    got = webp.decode_webp(data)
    assert got.mode == mode
    assert got.pixels.shape == want.shape and got.pixels.dtype == np.uint8
    np.testing.assert_array_equal(got.pixels, want)


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (16, 16), (37, 53), (33, 17), (70, 100)])
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
def test_lossy_matches_pil(hw, quality):
    """Every intra mode, the segments and skip flags, the normal loop filter
    at Pillow's levels, and the fancy upsampler at odd and even sizes."""
    check(save(texture(*hw, seed=sum(hw)), quality=quality, method=quality % 7))


@pytest.mark.parametrize("kind", ["smooth", "noise", "flat", "palette2", "palette4",
                                  "palette16", "palette200"])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless_matches_pil(kind, method):
    """The transforms (colour indexing with 8, 4, 2 and 1 pixels a byte),
    the colour cache, meta prefix codes and backward references."""
    rng = np.random.RandomState(method)
    h, w = 41, 67
    if kind == "smooth":
        a = texture(h, w, 1, noise=2.0)
    elif kind == "noise":
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    elif kind == "flat":
        a = np.full((h, w, 3), 77, np.uint8)
    else:
        n = int(kind[7:])
        a = rng.randint(0, 256, (n, 3)).astype(np.uint8)[rng.randint(0, n, (h, w))]
    check(save(a, lossless=True, method=method, quality=30 + 10 * method))


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("alpha_quality", [100, 40])
def test_alpha_matches_pil(lossless, alpha_quality):
    """RGBA: VP8L-coded ALPH chunks (filtered, and level-reduced below
    alpha quality 100) beside a lossy frame, or alpha in the VP8L ARGB."""
    a = texture(45, 61, 3, c=4)
    a[:5, :5, 3] = 0
    check(save(a, lossless=lossless, alpha_quality=alpha_quality, quality=70))


def _alph_filter(a, method):
    a = a.astype(np.int64)
    f = a.copy()
    f[0, 1:] = a[0, 1:] - a[0, :-1]
    if method == 1:
        f[1:, 0] = a[1:, 0] - a[:-1, 0]
        f[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        f[1:] = a[1:] - a[:-1]
    else:
        f[1:, 0] = a[1:, 0] - a[:-1, 0]
        g = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        f[1:, 1:] = a[1:, 1:] - g
    return (f & 255).astype(np.uint8)


def _riff(chunks):
    body = b"WEBP" + b"".join(k + struct.pack("<I", len(v)) + v + b"\x00" * (len(v) & 1)
                              for k, v in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(w, h, flags):
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (
        h - 1).to_bytes(3, "little")


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_raw_alpha_with_each_filter_matches_pil(method):
    rgba = texture(29, 38, 4, c=4)
    chunks = webp._chunks(save(rgba[..., :3], quality=80), "x")
    alpha = rgba[..., 3]
    alph = bytes([method << 2]) + (_alph_filter(alpha, method) if method else alpha).tobytes()
    check(_riff([_vp8x(38, 29, 0x10), (b"ALPH", alph), (b"VP8 ", chunks[b"VP8 "])]))


@pytest.mark.parametrize("fmt", ["lossy", "lossless", "rgba"])
@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_open_rgb_matches_gd3d_to_pil(tmp_path, fmt, orientation):
    """gd3d's _to_pil: EXIF orientation from the EXIF chunk, RGBA composited
    onto white; ICC profiles are ignored."""
    a = texture(23, 31, 5, c=4 if fmt == "rgba" else 3)
    ex = Image.Exif()
    ex[0x0112] = orientation
    path = tmp_path / "v.webp"
    path.write_bytes(save(a, lossless=fmt == "lossless", exif=ex.tobytes(),
                          icc_profile=b"\x00" * 16 if orientation == 3 else None))
    data = path.read_bytes()
    assert images.file_orientation(data) == orientation
    np.testing.assert_array_equal(images.open_rgb(path), np.asarray(gimages._to_pil(str(path))))
    assert images.image_size(path) == Image.open(path).size


def test_animated_and_broken_files_are_refused(tmp_path):
    """An animation is read now (frame 0, as Pillow gives it); a broken file
    (a VP8 interframe) and a RIFF file that is no WebP are still refused,
    naming the file."""
    frames = [Image.fromarray(texture(20, 24, s)) for s in range(3)]
    path = tmp_path / "anim.webp"
    frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], duration=40)
    check(path.read_bytes())
    bad = tmp_path / "bad.webp"
    data = save(texture(20, 24, 1), quality=60)
    bad.write_bytes(data[:20] + bytes([data[20] ^ 1]) + data[21:])  # a VP8 interframe
    with pytest.raises(ValueError, match="bad.webp.*key frame"):
        webp.decode_webp(bad)
    with pytest.raises(ValueError, match="not a WebP"):
        webp.decode_webp(b"RIFF\x00\x00\x00\x00WAVE")


def _riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def frame_chunks(still: bytes) -> bytes:
    """The image chunks (ALPH, VP8 , VP8L) of a still WebP file."""
    out, pos = b"", 12
    while pos + 8 <= len(still):
        kind, n = still[pos:pos + 4], struct.unpack("<I", still[pos + 4:pos + 8])[0]
        if kind in (b"ALPH", b"VP8 ", b"VP8L"):
            out += _riff_chunk(kind, still[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def anim_file(canvas_wh, frames, alpha: bool) -> bytes:
    """An animated WebP assembled by hand: VP8X (animation, and alpha where
    asked), ANIM (an opaque red background hint, which the decoder does not
    paint), then one ANMF a (x, y, w, h, still WebP bytes) frame, its
    offsets even as the format stores them."""
    cw, ch = canvas_wh
    body = _riff_chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                       + (cw - 1).to_bytes(3, "little") + (ch - 1).to_bytes(3, "little"))
    body += _riff_chunk(b"ANIM", bytes([0, 0, 255, 255]) + struct.pack("<H", 0))
    for x, y, w, h, still in frames:
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + bytes([0]))
        body += _riff_chunk(b"ANMF", head + frame_chunks(still))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


ANIM_CASES = {
    # PIL's save_all: lossy, lossless, and RGBA frames (alpha in every frame)
    "pil_lossy": dict(pil=dict(quality=70)),
    "pil_lossless": dict(pil=dict(lossless=True)),
    "pil_rgba": dict(pil=dict(quality=70), c=4),
    # by hand, frame 0 smaller than the canvas at an offset: lossy, lossless
    # and lossy with ALPH, with and without VP8X's alpha flag
    "offset_lossy": dict(frame=(6, 4, 20, 14, dict(quality=60)), alpha=False),
    "offset_lossy_alpha_flag": dict(frame=(6, 4, 20, 14, dict(quality=60)), alpha=True),
    "offset_lossless": dict(frame=(2, 10, 17, 9, dict(lossless=True)), alpha=False),
    "offset_alph": dict(frame=(8, 2, 21, 15, dict(quality=80)), alpha=True, c=4),
    "offset_lossless_alpha": dict(frame=(0, 6, 30, 11, dict(lossless=True)), alpha=True, c=4),
    "full_canvas": dict(frame=(0, 0, 32, 24, dict(quality=90)), alpha=False),
}


def anim_case(name, tmp_path):
    case = ANIM_CASES[name]
    c = case.get("c", 3)
    path = tmp_path / f"{name}.webp"
    if "pil" in case:
        frames = [Image.fromarray(texture(22, 30, s, c=c)) for s in range(3)]
        frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], duration=50,
                       **case["pil"])
        return path
    x, y, w, h, kw = case["frame"]
    arr = texture(h, w, x + y, c=c)
    if c == 4:
        arr[: h // 3, : w // 2, 3] = 0
        arr[h // 3:, :, 3] = 128 + arr[h // 3:, :, 3] // 2
    second = save(texture(h, w, 99, c=c), **kw)
    path.write_bytes(anim_file((32, 24), [(x, y, w, h, save(arr, **kw)), (0, 0, w, h, second)],
                               case["alpha"]))
    return path


@pytest.mark.parametrize("name", sorted(ANIM_CASES))
def test_animated_frame_0_matches_pil(name, tmp_path):
    """An animation's frame 0 on its canvas: Pillow's mode and pixels, PIL's
    convert("RGB") through decode_rgb and image_size, and gd3d's _to_pil
    (RGBA onto white) through open_rgb."""
    path = anim_case(name, tmp_path)
    data = path.read_bytes()
    check(data)
    with Image.open(path) as im:
        size, rgb = im.size, np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(images.decode_rgb(data, str(path), composite=False), rgb)
    assert images.image_size(path) == size
    np.testing.assert_array_equal(images.open_rgb(path), np.asarray(gimages._to_pil(str(path))))


def test_animated_frame_outside_its_canvas_is_refused(tmp_path):
    still = save(texture(14, 20, 1), quality=60)
    data = anim_file((24, 16), [(6, 4, 20, 14, still)], False)
    with pytest.raises(ValueError, match="outside its 24x16 canvas"):
        webp.decode_webp(data, "bad.webp")


# ------------------------------------------------------------- VP8 transcoder
def bool_encode(decisions):
    """RFC 6386's boolean encoder (section 7.3) over (prob, bit) pairs."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def add_one():
        i = len(out) - 1
        while i >= 0 and out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                add_one()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    c, v = count, bottom
    if v & (1 << (32 - c)):
        add_one()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def record(frame):
    """Decode a VP8 frame with recording boolean decoders: the first
    partition's decisions, the index where its macroblock modes start, and
    each macroblock row's token decisions."""
    made = []

    class Recorder(vp8.BoolDecoder):
        def __init__(self, *a):
            super().__init__(*a)
            self.rec = []
            made.append(self)

        def get(self, prob):
            bit = super().get(prob)
            self.rec.append((prob, bit))
            return bit

    rows = []
    parse = vp8._parse_modes

    def parse_modes(br, *a):
        if a[-1] == 0:  # mb_x == 0: a new row
            rows.append([len(p.rec) for p in made[1:]])
        return parse(br, *a)

    vp8.BoolDecoder, vp8._parse_modes = Recorder, parse_modes
    try:
        vp8.decode_vp8(frame)
    finally:
        vp8.BoolDecoder, vp8._parse_modes = Recorder.__bases__[0], parse
    parts = made[1:]
    rows.append([len(p.rec) for p in parts])
    n = len(parts)
    row_tokens = [parts[r % n].rec[rows[r][r % n]:rows[r + 1][r % n]]
                  for r in range(len(rows) - 1)]
    return made[0].rec, rows[0], row_tokens


def _bits(value, n):
    return [(128, (value >> (n - 1 - i)) & 1) for i in range(n)]


def transcode(frame, simple=None, level=None, sharpness=None, deltas=None, parts=1):
    """The frame with its filter header and token partitions rewritten."""
    head, _, row_tokens = record(frame)
    # find where the filter fields start and the partition count ends
    i = 0

    def take(n):
        nonlocal i
        v = 0
        for _ in range(n):
            v = (v << 1) | head[i][1]
            i += 1
        return v

    take(2)
    if take(1):
        update_map, update_data = take(1), take(1)
        if update_data:
            take(1)
            for _ in range(4):
                if take(1):
                    take(8)
            for _ in range(4):
                if take(1):
                    take(7)
        if update_map:
            for _ in range(3):
                if take(1):
                    take(8)
    start = i
    old_simple, old_level, old_sharp = take(1), take(6), take(3)
    if take(1) and take(1):
        for _ in range(8):
            if take(1):
                take(7)
    take(2)
    end = i
    new = _bits(old_simple if simple is None else simple, 1)
    new += _bits(old_level if level is None else level, 6)
    new += _bits(old_sharp if sharpness is None else sharpness, 3)
    if deltas is None:
        new += _bits(0, 1)
    else:
        new += _bits(1, 1) + _bits(1, 1)
        for d in deltas:  # 4 reference then 4 mode deltas
            new += _bits(1, 1) + _bits(abs(d), 6) + _bits(d < 0, 1) if d else _bits(0, 1)
    new += _bits(parts.bit_length() - 1, 2)
    first = bool_encode(head[:start] + new + head[end:])
    streams = [bool_encode(sum(row_tokens[p::parts], [])) for p in range(parts)]
    tag = (len(first) << 5) | (frame[0] & 0x1E)
    out = struct.pack("<I", tag)[:3] + frame[3:10] + first
    out += b"".join(len(s).to_bytes(3, "little") for s in streams[:-1]) + b"".join(streams)
    return _riff([(b"VP8 ", out)])


@pytest.fixture(scope="module")
def frame():
    return webp._chunks(save(texture(53, 70, 8, noise=25.0), quality=60, method=3), "x")[b"VP8 "]


def test_transcoder_reproduces_the_file(frame):
    """The rewritten file with no change decodes (in Pillow) to the
    original's pixels: the boolean encoder and the recording are exact."""
    with Image.open(io.BytesIO(_riff([(b"VP8 ", frame)]))) as im:
        want = np.asarray(im)
    with Image.open(io.BytesIO(transcode(frame))) as im:
        np.testing.assert_array_equal(np.asarray(im), want)


@pytest.mark.parametrize("variant", [
    dict(simple=1), dict(simple=1, sharpness=5), dict(level=0), dict(level=63),
    dict(sharpness=1), dict(sharpness=3), dict(sharpness=4), dict(sharpness=6),
    dict(sharpness=7), dict(deltas=[5, 0, 0, 0, -9, 0, 0, 0]),
    dict(deltas=[-20, 0, 0, 0, 30, 0, 0, 0], simple=1), dict(parts=2), dict(parts=4),
    dict(parts=8, sharpness=2),
], ids=lambda v: "-".join(f"{k}{v[k] if k != 'deltas' else v[k][0]}" for k in sorted(v)))
def test_transcoded_variants_match_pil(frame, variant):
    check(transcode(frame, **variant))
