"""WebP lossless (VP8L) decoding in Python and numpy, as libwebp decodes it
(the WebP Lossless Bitstream Specification, RFC 9649):

  * the LSB-first bit reader, canonical prefix codes (simple and normal,
    with the code-length code and its repeat codes), one group of five
    codes per meta-prefix-code region (the entropy image);
  * LZ77 backward references with the 120-entry distance map, and the
    colour cache (hash 0x1e35a7bd);
  * the four inverse transforms, last read first: predictor (the 14
    modes), cross-colour, subtract-green, and colour indexing with pixel
    bundling.

`decode_image_stream(data, pos, width, height)` is the headerless image
stream that WebP's ALPH chunk also uses; `decode_vp8l(data)` reads the
5-byte header first. Both return (H, W) uint32 ARGB.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the distance map: (dx, dy) of plane codes 1-120
_DIST_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


class Error(ValueError):
    pass


class BitReader:
    """LSB-first bits of data[pos:], through a 64-bit little-endian word at
    every byte; reads past the end give zeros and set `eos`, as libwebp's
    reader does."""

    def __init__(self, data: bytes, pos: int = 0):
        n = len(data) - pos
        b = np.frombuffer(bytes(data[pos:]) + bytes(8), np.uint8).astype(np.uint64)
        w = np.zeros(n + 1, np.uint64)
        for k in range(8):
            w |= b[k:k + n + 1] << np.uint64(8 * k)
        self.words = w.tolist() + [0] * 8
        self.nbits = 8 * n
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.words[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    @property
    def eos(self) -> bool:
        return self.pos > self.nbits


class Code:
    """A canonical prefix code: decode() reads one symbol. One used
    symbol costs no bits."""

    def __init__(self, lengths: List[int]):
        used = [s for s, ln in enumerate(lengths) if ln]
        if not used:
            raise Error("VP8L prefix code without symbols")
        if len(used) == 1:
            self.single, self.bits, self.table = used[0], 0, None
            return
        self.single = None
        maxlen = max(lengths)
        counts = [0] * (maxlen + 1)
        for ln in lengths:
            counts[ln] += 1
        counts[0] = 0
        code, next_code = 0, [0] * (maxlen + 2)
        for ln in range(1, maxlen + 1):
            code = (code + counts[ln - 1]) << 1
            next_code[ln] = code
        size = 1 << maxlen
        table = [None] * size
        for s, ln in enumerate(lengths):
            if not ln:
                continue
            c = next_code[ln]
            next_code[ln] += 1
            if c >= (1 << ln):
                raise Error("VP8L prefix code is over-subscribed")
            rev = int(format(c, f"0{ln}b")[::-1], 2)
            for i in range(rev, size, 1 << ln):
                table[i] = (s, ln)
        if any(t is None for t in table):
            raise Error("VP8L prefix code is incomplete")
        self.bits, self.table, self.mask = maxlen, table, size - 1

    def decode(self, br: BitReader) -> int:
        if self.table is None:
            return self.single
        p = br.pos
        s, ln = self.table[(br.words[p >> 3] >> (p & 7)) & self.mask]
        br.pos = p + ln
        return s


def _read_code(br: BitReader, alphabet: int) -> Code:
    lengths = [0] * alphabet
    if br.read(1):  # simple code: one or two symbols of length 1
        n = br.read(1) + 1
        s0 = br.read(8 if br.read(1) else 1)
        if s0 >= alphabet:
            raise Error("VP8L simple code symbol out of range")
        lengths[s0] = 1
        if n == 2:
            s1 = br.read(8)
            if s1 >= alphabet:
                raise Error("VP8L simple code symbol out of range")
            lengths[s1] = 1
        return Code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clc = Code(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise Error("VP8L code lengths past the alphabet")
    else:
        max_symbol = alphabet
    s, prev = 0, 8
    while s < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = clc.decode(br)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if s + rep > alphabet:
                raise Error("VP8L code length repeat past the alphabet")
            fill = prev if c == 16 else 0
            for _ in range(rep):
                lengths[s] = fill
                s += 1
    return Code(lengths)


def _copy_length(br: BitReader, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: BitReader, w: int, h: int, level0: bool) -> List[int]:
    """One entropy-coded image of w x h ARGB pixels (no transforms)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise Error(f"VP8L colour cache of {cache_bits} bits")
    meta_bits, meta, meta_w = 0, None, 0
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = -(-w // (1 << meta_bits))
        mh = -(-h // (1 << meta_bits))
        meta = [(p >> 8) & 0xFFFF for p in _entropy_image(br, meta_w, mh, False)]
    ngroups = max(meta) + 1 if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(ngroups):
        groups.append((_read_code(br, 256 + 24 + cache_size), _read_code(br, 256),
                       _read_code(br, 256), _read_code(br, 256), _read_code(br, 40)))
    total = w * h
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0  # pixels out[:cached] are in the cache
    i = 0
    g = groups[0]
    dist_map = [max(1, dx + dy * w) for dx, dy in _DIST_MAP]
    while i < total:
        if meta is not None:
            y, x = divmod(i, w)
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        green, red, blue, alpha, dist = g
        code = green.decode(br)
        if code < 256:
            r = red.decode(br)
            b = blue.decode(br)
            out[i] = (alpha.decode(br) << 24) | (r << 16) | (code << 8) | b
            i += 1
        elif code < 280:
            length = _copy_length(br, code - 256)
            dcode = _copy_length(br, dist.decode(br))
            d = dcode - 120 if dcode > 120 else dist_map[dcode - 1]
            if d > i or i + length > total:
                raise Error("VP8L backward reference outside the image")
            for k in range(length):
                out[i + k] = out[i + k - d]
            i += length
        elif code < 280 + cache_size:
            while cached < i:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
            out[i] = cache[code - 280]
            i += 1
        else:
            raise Error("VP8L symbol out of range")
        if cache_size:
            while cached < i:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
        if br.eos:
            raise Error("VP8L data ran out")
    return out


def _add(a, b):
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clamp_add_sub_full(a, b, c):
    out = 0
    for s in (0, 8, 16, 24):
        v = ((a >> s) & 255) + ((b >> s) & 255) - ((c >> s) & 255)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_add_sub_half(a, b):
    out = 0
    for s in (0, 8, 16, 24):
        x, y = (a >> s) & 255, (b >> s) & 255
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _select(L, T, TL):
    pl = pt = 0
    for s in (0, 8, 16, 24):
        t, l, tl = (T >> s) & 255, (L >> s) & 255, (TL >> s) & 255
        pl += abs(t - tl)
        pt += abs(l - tl)
    return L if pl < pt else T


def _predict(mode, L, T, TR, TL):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:
        return _select(L, T, TL)
    if mode == 12:
        return _clamp_add_sub_full(L, T, TL)
    if mode == 13:
        return _clamp_add_sub_half(_avg2(L, T), TL)
    return 0xFF000000


def _inverse_predictor(px: List[int], w: int, h: int, bits: int, modes: List[int]) -> None:
    bw = -(-w // (1 << bits))
    px[0] = _add(px[0], 0xFF000000)
    for x in range(1, w):
        px[x] = _add(px[x], px[x - 1])
    for y in range(1, h):
        row = y * w
        px[row] = _add(px[row], px[row - w])
        mrow = (y >> bits) * bw
        for x in range(1, w):
            i = row + x
            mode = (modes[mrow + (x >> bits)] >> 8) & 15
            if mode == 1:
                px[i] = _add(px[i], px[i - 1])
            elif mode == 2:
                px[i] = _add(px[i], px[i - w])
            else:
                px[i] = _add(px[i], _predict(mode, px[i - 1], px[i - w], px[i - w + 1],
                                             px[i - w - 1]))


def _inverse_cross_color(px: np.ndarray, w: int, h: int, bits: int, elems: List[int]):
    bw = -(-w // (1 << bits))
    e = np.asarray(elems, np.int64).reshape(-1, bw)
    e = np.repeat(np.repeat(e, 1 << bits, 0), 1 << bits, 1)[:h, :w]
    g2r = ((e & 255) ^ 128) - 128
    g2b = (((e >> 8) & 255) ^ 128) - 128
    r2b = (((e >> 16) & 255) ^ 128) - 128
    a = px.reshape(h, w)
    green = (((a >> 8) & 255) ^ 128) - 128
    red = ((a >> 16) & 255) + ((g2r * green) >> 5)
    red &= 255
    sred = (red ^ 128) - 128
    blue = (a & 255) + ((g2b * green) >> 5) + ((r2b * sred) >> 5)
    blue &= 255
    return ((a & 0xFF00FF00) | (red << 16) | blue).reshape(-1)


def _inverse_subtract_green(px: np.ndarray) -> np.ndarray:
    g = (px >> 8) & 255
    r = (((px >> 16) & 255) + g) & 255
    b = ((px & 255) + g) & 255
    return (px & 0xFF00FF00) | (r << 16) | b


def _inverse_color_indexing(px: np.ndarray, w: int, h: int, bits: int, palette: List[int],
                            packed_w: int) -> np.ndarray:
    lut = np.zeros(256, np.int64)
    lut[:len(palette)] = palette
    idx = (px.reshape(h, packed_w) >> 8) & 255
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        x = np.arange(w)
        idx = (idx[:, x >> bits] >> ((x & (per - 1)) * bpp)) & ((1 << bpp) - 1)
    return lut[idx].reshape(-1)


def decode_image_stream(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """The main image stream of w x h at data[pos:] (transforms, then the
    entropy-coded image) -> (h, w) uint32 ARGB."""
    br = BitReader(data, pos)
    transforms: List[Tuple] = []
    seen = set()
    xsize = w
    while br.read(1):
        t = br.read(2)
        if t in seen:
            raise Error("VP8L transform repeated")
        seen.add(t)
        if t in (0, 1):
            bits = br.read(3) + 2
            sub = _entropy_image(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((t, xsize, bits, sub))
        elif t == 2:
            transforms.append((t, xsize))
        else:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _entropy_image(br, n, 1, False)
            for i in range(1, n):
                pal[i] = _add(pal[i], pal[i - 1])
            packed = -(-xsize // (1 << bits))
            transforms.append((t, xsize, bits, pal, packed))
            xsize = packed
    px = _entropy_image(br, xsize, h, True)
    arr = None
    for tr in reversed(transforms):
        t, tw = tr[0], tr[1]
        if t == 0:
            if arr is not None:
                px = arr.tolist()
                arr = None
            _inverse_predictor(px, tw, h, tr[2], tr[3])
        else:
            if arr is None:
                arr = np.asarray(px, np.int64)
            if t == 1:
                arr = _inverse_cross_color(arr, tw, h, tr[2], tr[3])
            elif t == 2:
                arr = _inverse_subtract_green(arr)
            else:
                arr = _inverse_color_indexing(arr, tw, h, tr[2], tr[3], tr[4])
    if arr is None:
        arr = np.asarray(px, np.int64)
    return arr.astype(np.uint32).reshape(h, w)


def vp8l_header(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L bitstream."""
    if len(data) < 5 or data[0] != 0x2F:
        raise Error("not a VP8L bitstream (no 0x2f signature)")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise Error(f"VP8L version {v >> 29}")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L bitstream -> (H, W) uint32 ARGB."""
    w, h, _ = vp8l_header(data)
    return decode_image_stream(data, 5, w, h)
