"""WebP lossy (VP8 key frame) decoding in Python and numpy, as libwebp
decodes it (RFC 6386; libwebp's src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
frame_dec.c and src/dsp/dec.c):

  * the boolean entropy decoder; the frame header's segments (quantiser and
    filter level, absolute or delta), filter type, level and sharpness with
    the reference / mode deltas, the token partitions, the quantiser
    indices through the DC and AC tables, and the token probabilities with
    their updates;
  * per macroblock: segment id, skip flag, the 16x16 or the sixteen 4x4
    luma modes (the key-frame tree and kf_bmode_probs on the above and
    left modes), the chroma mode, and the tokens (bands, the three
    contexts, the DCT extra-bit categories), dequantised, the Y2 block
    through the inverse WHT;
  * intra prediction on the unfiltered reconstruction (DC / V / H / TM for
    16x16 and 8x8 chroma, the ten 4x4 modes with libwebp's 127 / 129
    borders and replicated top-right samples), plus the inverse DCT;
  * the loop filter after the frame, macroblock by macroblock: simple, or
    normal with its high-edge-variance test and the 2-, 4- and 6-tap
    adjustments, at each segment's level, interior limit from the
    sharpness, and inner edges where the block codes any coefficient or
    4x4 modes.

`decode_vp8(data)` returns the (H, W) Y and the (ceil(H/2), ceil(W/2)) U and
V planes, which data/webp.py upsamples and converts as libwebp does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# RFC 6386's dc_qlookup and ac_qlookup
_DC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157]
_AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90,
    92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284]
# RFC 6386's coeff_update_probs[4][8][3][11]
_COEFF_UPDATE_PROBS = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff"), np.uint8)
# RFC 6386's default_coeff_probs[4][8][3][11]
_DEFAULT_COEFF_PROBS = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080"), np.uint8)
# RFC 6386's kf_bmode_probs[10][10][9] (above, left)
_KF_BMODE_PROBS = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"), np.uint8)

_COEF_UPDATE = _COEFF_UPDATE_PROBS.reshape(4, 8, 3, 11).tolist()
_COEF_DEFAULT = _DEFAULT_COEFF_PROBS.reshape(4, 8, 3, 11).tolist()
_BMODE_PROBS = _KF_BMODE_PROBS.reshape(10, 10, 9).tolist()
_ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CAT = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
        [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
# 4x4 modes, libwebp's order; 16x16 and chroma modes reuse DC, TM, VE, HE
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# the key-frame tree of the 4x4 modes: leaves are -mode
_BMODE_TREE = [-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL,
               8, -B_HD, -B_HU]
_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]


class Error(ValueError):
    pass


class BoolDecoder:
    """RFC 6386's boolean decoder over data[start:end]; zeros past the end,
    as libwebp reads them."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, min(end, len(data))
        self.range, self.count = 255, 0
        self.value = (self._byte() << 8) | self._byte()

    def _byte(self) -> int:
        p = self.pos
        self.pos = p + 1
        return self.data[p] if p < self.end else 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        if self.range < 128:
            shift = _NORM[self.range]
            self.range <<= shift
            self.value <<= shift
            self.count += shift
            if self.count >= 8:
                self.count -= 8
                self.value |= self._byte() << self.count
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(128)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(128) else v

    def flag_signed(self, n: int) -> int:
        return self.signed(n) if self.get(128) else 0


def _large_value(get, p) -> int:
    if not get(p[3]):
        if not get(p[4]):
            return 2
        return 3 + get(p[5])
    if not get(p[6]):
        if not get(p[7]):
            return 5 + get(159)
        v = 7 + 2 * get(165)
        return v + get(145)
    bit1 = get(p[8])
    bit0 = get(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT[cat]:
        v += v + get(prob)
    return v + 3 + (8 << cat)


def _coeffs(get, prob, ctx: int, dq_dc: int, dq_ac: int, n: int, out: list, base: int) -> int:
    """libwebp's GetCoeffs: tokens of one block from position n into
    out[base:base + 16] (natural order, dequantised); returns the position
    after the last token."""
    p = prob[n][ctx]
    while n < 16:
        if not get(p[0]):
            return n
        while not get(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not get(p[2]):
            v = 1
            p_next = prob[n + 1][1]
        else:
            v = _large_value(get, p)
            p_next = prob[n + 1][2]
        if get(128):
            v = -v
        out[base + _ZIGZAG[n]] = v * (dq_ac if n else dq_dc)
        n += 1
        p = p_next
    return 16


def _wht(dc: List[int]) -> List[int]:
    """TransformWHT: the Y2 block -> the 16 luma DCs, raster order."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i] = a0 + a1
        tmp[8 + i] = a0 - a1
        tmp[4 + i] = a3 + a2
        tmp[12 + i] = a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return out


def idct(blocks: np.ndarray) -> np.ndarray:
    """TransformOne on (N, 16) raster-order coefficients -> (N, 4, 4) the
    residual each pixel gets, (v >> 3)."""
    x = blocks.astype(np.int64).reshape(-1, 4, 4)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    a = x[:, 0] + x[:, 2]  # vertical pass, over the columns
    b = x[:, 0] - x[:, 2]
    c = mul2(x[:, 1]) - mul1(x[:, 3])
    d = mul1(x[:, 1]) + mul2(x[:, 3])
    t = np.stack([a + d, b + c, b - c, a - d], axis=1)  # rows 0-3
    dc = t[:, :, 0] + 4  # horizontal pass, each row
    a = dc + t[:, :, 2]
    b = dc - t[:, :, 2]
    c = mul2(t[:, :, 1]) - mul1(t[:, :, 3])
    d = mul1(t[:, :, 1]) + mul2(t[:, :, 3])
    return np.stack([a + d, b + c, b - c, a - d], axis=2) >> 3


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, w: np.ndarray, r: int, c: int) -> List[List[int]]:
    """The 4x4 prediction of block (r, c) of the work area w (row r - 1
    above it, column c - 1 left of it, 8 samples above from column c)."""
    top = w[r - 1, c - 1:c + 8].tolist()  # X, A..H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = w[r:r + 4, c - 1].tolist()
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == B_TM:
        return [[min(255, max(0, t + left - X)) for t in (A, B, C, D)] for left in (I, J, K, L)]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row] * 4
    if mode == B_HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                                   _avg3(K, L, L))]
    o = [[0] * 4 for _ in range(4)]

    def put(pairs, v):
        for x, y in pairs:
            o[y][x] = v

    if mode == B_RD:
        put([(0, 3)], _avg3(J, K, L))
        put([(1, 3), (0, 2)], _avg3(I, J, K))
        put([(2, 3), (1, 2), (0, 1)], _avg3(X, I, J))
        put([(3, 3), (2, 2), (1, 1), (0, 0)], _avg3(A, X, I))
        put([(3, 2), (2, 1), (1, 0)], _avg3(B, A, X))
        put([(3, 1), (2, 0)], _avg3(C, B, A))
        put([(3, 0)], _avg3(D, C, B))
    elif mode == B_LD:
        put([(0, 0)], _avg3(A, B, C))
        put([(1, 0), (0, 1)], _avg3(B, C, D))
        put([(2, 0), (1, 1), (0, 2)], _avg3(C, D, E))
        put([(3, 0), (2, 1), (1, 2), (0, 3)], _avg3(D, E, F))
        put([(3, 1), (2, 2), (1, 3)], _avg3(E, F, G))
        put([(3, 2), (2, 3)], _avg3(F, G, H))
        put([(3, 3)], _avg3(G, H, H))
    elif mode == B_VR:
        put([(0, 0), (1, 2)], _avg2(X, A))
        put([(1, 0), (2, 2)], _avg2(A, B))
        put([(2, 0), (3, 2)], _avg2(B, C))
        put([(3, 0)], _avg2(C, D))
        put([(0, 3)], _avg3(K, J, I))
        put([(0, 2)], _avg3(J, I, X))
        put([(0, 1), (1, 3)], _avg3(I, X, A))
        put([(1, 1), (2, 3)], _avg3(X, A, B))
        put([(2, 1), (3, 3)], _avg3(A, B, C))
        put([(3, 1)], _avg3(B, C, D))
    elif mode == B_VL:
        put([(0, 0)], _avg2(A, B))
        put([(1, 0), (0, 2)], _avg2(B, C))
        put([(2, 0), (1, 2)], _avg2(C, D))
        put([(3, 0), (2, 2)], _avg2(D, E))
        put([(0, 1)], _avg3(A, B, C))
        put([(1, 1), (0, 3)], _avg3(B, C, D))
        put([(2, 1), (1, 3)], _avg3(C, D, E))
        put([(3, 1), (2, 3)], _avg3(D, E, F))
        put([(3, 2)], _avg3(E, F, G))
        put([(3, 3)], _avg3(F, G, H))
    elif mode == B_HU:
        put([(0, 0)], _avg2(I, J))
        put([(2, 0), (0, 1)], _avg2(J, K))
        put([(2, 1), (0, 2)], _avg2(K, L))
        put([(1, 0)], _avg3(I, J, K))
        put([(3, 0), (1, 1)], _avg3(J, K, L))
        put([(3, 1), (1, 2)], _avg3(K, L, L))
        put([(3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)], L)
    elif mode == B_HD:
        put([(0, 0), (2, 1)], _avg2(I, X))
        put([(0, 1), (2, 2)], _avg2(J, I))
        put([(0, 2), (2, 3)], _avg2(K, J))
        put([(0, 3)], _avg2(L, K))
        put([(3, 0)], _avg3(A, B, C))
        put([(2, 0)], _avg3(X, A, B))
        put([(1, 0), (3, 1)], _avg3(I, X, A))
        put([(1, 1), (3, 2)], _avg3(J, I, X))
        put([(1, 2), (3, 3)], _avg3(K, J, I))
        put([(1, 3)], _avg3(L, K, J))
    else:
        raise Error(f"VP8 4x4 mode {mode}")
    return o


def _pred_block(mode: int, w: np.ndarray, n: int, has_top: bool, has_left: bool) -> np.ndarray:
    """16x16 luma (n = 16) or 8x8 chroma (n = 8) prediction from the work
    area w ((n + 1) x (n + 1): the top row and left column around it)."""
    top = w[0, 1:n + 1].astype(np.int64)
    left = w[1:n + 1, 0].astype(np.int64)
    shift = 5 if n == 16 else 4
    if mode == B_DC:
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + n) >> shift
        elif has_left:
            v = (int(left.sum()) + n // 2) >> (shift - 1)
        elif has_top:
            v = (int(top.sum()) + n // 2) >> (shift - 1)
        else:
            v = 0x80
        return np.full((n, n), v, np.int64)
    if mode == B_VE:
        return np.broadcast_to(top, (n, n))
    if mode == B_HE:
        return np.broadcast_to(left[:, None], (n, n))
    if mode == B_TM:
        return np.clip(top[None, :] + left[:, None] - int(w[0, 0]), 0, 255)
    raise Error(f"VP8 intra mode {mode}")


def _header(data: bytes):
    if len(data) < 10:
        raise Error("truncated VP8 frame")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise Error("VP8 interframe (not a key frame)")
    if (bits >> 1) & 7 > 3:
        raise Error(f"VP8 profile {(bits >> 1) & 7}")
    if data[3:6] != b"\x9d\x01\x2a":
        raise Error("VP8 key frame without its start code")
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    return bits >> 5, w, h


def vp8_size(data: bytes) -> Tuple[int, int]:
    _, w, h = _header(data)
    return w, h


def _parse_modes(br: BoolDecoder, seg_probs, update_map: bool, skip_p, intra_t: list,
                 intra_l: list, mb_x: int):
    """One macroblock's segment, skip flag, luma modes and chroma mode."""
    get = br.get
    seg = 0
    if update_map:
        seg = get(seg_probs[1]) if not get(seg_probs[0]) else 2 + get(seg_probs[2])
    skip = get(skip_p) if skip_p is not None else 0
    top = intra_t[4 * mb_x:4 * mb_x + 4]
    if get(145):  # 16x16
        ymode = (B_TM if get(128) else B_HE) if get(156) else (B_VE if get(163) else B_DC)
        intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
        intra_l[:] = [ymode] * 4
        modes = ymode
    else:
        modes = []
        for y in range(4):
            ym = intra_l[y]
            for x in range(4):
                prob = _BMODE_PROBS[top[x]][ym]
                i = _BMODE_TREE[get(prob[0])]
                while i > 0:
                    i = _BMODE_TREE[2 * i + get(prob[i])]
                ym = -i
                top[x] = ym
            modes.extend(top)
            intra_l[y] = ym
        intra_t[4 * mb_x:4 * mb_x + 4] = top
    uvmode = B_DC if not get(142) else (B_VE if not get(114) else (B_TM if get(183) else B_HE))
    return seg, skip, modes, uvmode


def decode_vp8(data: bytes):
    """A VP8 key frame -> (Y (H, W), U, V (ceil(H/2), ceil(W/2))) uint8."""
    part0, w, h = _header(data)
    if w == 0 or h == 0:
        raise Error("VP8 frame of zero size")
    pos = 10
    if pos + part0 > len(data):
        raise Error("truncated VP8 first partition")
    br = BoolDecoder(data, pos, pos + part0)
    get = br.get
    get(128)  # colour space
    get(128)  # clamping type (libwebp always clamps)
    use_segment = get(128)
    update_map, absolute = 0, 0
    seg_q, seg_lf = [0] * 4, [0] * 4
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = get(128)
        if get(128):
            absolute = get(128)
            seg_q = [br.flag_signed(7) for _ in range(4)]
            seg_lf = [br.flag_signed(6) for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if get(128) else 255 for _ in range(3)]
    simple = get(128)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = get(128)
    if use_lf_delta and get(128):
        for i in range(4):
            if get(128):
                ref_delta[i] = br.signed(6)
        for i in range(4):
            if get(128):
                mode_delta[i] = br.signed(6)
    filter_type = 0 if level == 0 else 1 if simple else 2
    nparts = 1 << br.value_bits(2)
    ppos = pos + part0
    sizes_at = ppos
    ppos += 3 * (nparts - 1)
    if ppos > len(data):
        raise Error("truncated VP8 partition sizes")
    parts = []
    for i in range(nparts):
        if i < nparts - 1:
            size = int.from_bytes(data[sizes_at + 3 * i:sizes_at + 3 * i + 3], "little")
        else:
            size = len(data) - ppos
        parts.append(BoolDecoder(data, ppos, ppos + size))
        ppos += size
    if ppos > len(data):
        raise Error("truncated VP8 token partitions")
    base_q = br.value_bits(7)
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = (br.flag_signed(4) for _ in range(5))

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    dqm = []
    for s in range(4):
        if use_segment:
            q = seg_q[s] + (0 if absolute else base_q)
        else:
            q = base_q
        y2_ac = (_AC_TABLE[clip(q + dqy2_ac, 127)] * 101581) >> 16
        dqm.append((_DC_TABLE[clip(q + dqy1_dc, 127)], _AC_TABLE[clip(q, 127)],
                    _DC_TABLE[clip(q + dqy2_dc, 127)] * 2, max(y2_ac, 8),
                    _DC_TABLE[clip(q + dquv_dc, 117)], _AC_TABLE[clip(q + dquv_ac, 127)]))
    get(128)  # refresh entropy probabilities: one key frame, no effect
    probs = [[[[br.value_bits(8) if get(_COEF_UPDATE[t][b][c][p]) else _COEF_DEFAULT[t][b][c][p]
                for p in range(11)] for c in range(3)] for b in range(8)] for t in range(4)]
    bands = [[probs[t][_BANDS[n]] for n in range(17)] for t in range(4)]
    skip_p = br.value_bits(8) if get(128) else None

    # filter strengths per segment and 4x4-ness (PrecomputeFilterStrengths)
    fstr = [[None, None] for _ in range(4)]
    for s in range(4):
        base = (seg_lf[s] + (0 if absolute else level)) if use_segment else level
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = clip(lv, 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                fstr[s][i4] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0)
            else:
                fstr[s][i4] = (0, 0, 0)

    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    coef = np.zeros((mbh, mbw, 24, 16), np.int32)
    info = []  # per macroblock: (is_i4x4, modes, uvmode, filter (limit, ilevel, hev), inner)
    intra_t = [B_DC] * (4 * mbw)
    top_y = [[0] * 4 for _ in range(mbw)]
    top_u = [[0] * 2 for _ in range(mbw)]
    top_v = [[0] * 2 for _ in range(mbw)]
    top_dc = [0] * mbw
    for mb_y in range(mbh):
        intra_l = [B_DC] * 4
        left_y, left_u, left_v, left_dc = [0] * 4, [0] * 2, [0] * 2, 0
        tb = parts[mb_y & (nparts - 1)]
        tget = tb.get
        row_info = []
        for mb_x in range(mbw):
            seg, skip, modes, uvmode = _parse_modes(br, seg_probs, update_map, skip_p, intra_t,
                                                    intra_l, mb_x)
            i4 = isinstance(modes, list)
            nonzero = False
            if not skip:
                q = dqm[seg]
                out = [0] * 384
                ty, tu, tv = top_y[mb_x], top_u[mb_x], top_v[mb_x]
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(tget, bands[1], top_dc[mb_x] + left_dc, q[2], q[3], 0, dc, 0)
                    top_dc[mb_x] = left_dc = 1 if nz > 0 else 0
                    for k, v in enumerate(_wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16):
                        out[16 * k] = v
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                for y in range(4):
                    lb = left_y[y]
                    for x in range(4):
                        b = 16 * (4 * y + x)
                        nz = _coeffs(tget, ac, lb + ty[x], q[0], q[1], first, out, b)
                        lb = 1 if nz > first else 0
                        ty[x] = lb
                        if nz > 1 or out[b]:
                            nonzero = True
                    left_y[y] = lb
                for ch, (tc, lc) in enumerate(((tu, left_u), (tv, left_v))):
                    for y in range(2):
                        lb = lc[y]
                        for x in range(2):
                            b = 16 * (16 + 4 * ch + 2 * y + x)
                            nz = _coeffs(tget, bands[2], lb + tc[x], q[4], q[5], 0, out, b)
                            lb = 1 if nz > 0 else 0
                            tc[x] = lb
                            if nz > 1 or out[b]:
                                nonzero = True
                        lc[y] = lb
                coef[mb_y, mb_x] = np.asarray(out, np.int32).reshape(24, 16)
            else:
                top_y[mb_x][:] = [0] * 4
                top_u[mb_x][:] = [0, 0]
                top_v[mb_x][:] = [0, 0]
                left_y, left_u, left_v = [0] * 4, [0] * 2, [0] * 2
                if not i4:
                    top_dc[mb_x] = left_dc = 0
            row_info.append((i4, modes, uvmode, fstr[seg][1 if i4 else 0], i4 or nonzero))
        info.append(row_info)

    res = idct(coef.reshape(-1, 16)).reshape(mbh, mbw, 24, 4, 4)
    Y = np.zeros((mbh * 16, mbw * 16), np.int64)
    U = np.zeros((mbh * 8, mbw * 8), np.int64)
    V = np.zeros((mbh * 8, mbw * 8), np.int64)
    for mb_y in range(mbh):
        for mb_x in range(mbw):
            i4, modes, uvmode, _, _ = info[mb_y][mb_x]
            _reconstruct(Y, U, V, mb_x, mb_y, mbw, i4, modes, uvmode, res[mb_y, mb_x])
    if filter_type:
        _loop_filter(Y, U, V, info, filter_type)
    ch, cw = (h + 1) >> 1, (w + 1) >> 1
    return (Y[:h, :w].astype(np.uint8), U[:ch, :cw].astype(np.uint8),
            V[:ch, :cw].astype(np.uint8))


def _reconstruct(Y, U, V, mb_x, mb_y, mbw, i4, modes, uvmode, res):
    """Predict one macroblock from the unfiltered frame and add its residual."""
    y0, x0 = 16 * mb_y, 16 * mb_x
    # work area: row 0 the samples above (20 wide), column 0 those to the left
    wk = np.zeros((17, 21), np.int64)
    if mb_y == 0:
        wk[0, :] = 127
    else:
        wk[0, 1:17] = Y[y0 - 1, x0:x0 + 16]
        wk[0, 0] = 129 if mb_x == 0 else Y[y0 - 1, x0 - 1]
        if mb_x == mbw - 1:
            wk[0, 17:21] = Y[y0 - 1, x0 + 15]
        else:
            wk[0, 17:21] = Y[y0 - 1, x0 + 16:x0 + 20]
    wk[1:17, 0] = 129 if mb_x == 0 else Y[y0:y0 + 16, x0 - 1]
    if i4:
        wk[4, 17:21] = wk[8, 17:21] = wk[12, 17:21] = wk[0, 17:21]
        for n in range(16):
            by, bx = divmod(n, 4)
            r, c = 1 + 4 * by, 1 + 4 * bx
            pred = np.asarray(_pred4(modes[n], wk, r, c), np.int64)
            wk[r:r + 4, c:c + 4] = np.clip(pred + res[n], 0, 255)
    else:
        pred = _pred_block(modes, wk[:, :17], 16, mb_y > 0, mb_x > 0)
        blocks = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        wk[1:17, 1:17] = np.clip(pred + blocks, 0, 255)
    Y[y0:y0 + 16, x0:x0 + 16] = wk[1:17, 1:17]
    cy, cx = 8 * mb_y, 8 * mb_x
    for plane, k in ((U, 16), (V, 20)):
        wc = np.zeros((9, 9), np.int64)
        if mb_y == 0:
            wc[0, :] = 127
        else:
            wc[0, 1:] = plane[cy - 1, cx:cx + 8]
            wc[0, 0] = 129 if mb_x == 0 else plane[cy - 1, cx - 1]
        wc[1:, 0] = 129 if mb_x == 0 else plane[cy:cy + 8, cx - 1]
        pred = _pred_block(uvmode, wc, 8, mb_y > 0, mb_x > 0)
        blocks = res[k:k + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
        plane[cy:cy + 8, cx:cx + 8] = np.clip(pred + blocks, 0, 255)


# ---------------------------------------------------------------- loop filter
def _sclip1(v):
    return np.clip(v, -128, 127)


def _filter_edge(P: np.ndarray, hev_thresh: int, thresh: int, ithresh: int, mode: str):
    """One edge: P (8, n) holds p3 p2 p1 p0 q0 q1 q2 q3 along its first
    axis (n positions along the edge), filtered in place. mode "simple",
    "mb" (6-tap where not hev) or "inner" (4-tap)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = P
    thresh2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if mode == "simple":
        hev = np.ones_like(need)
    else:
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0) > hev_thresh)
    if not need.any():
        return
    # DoFilter2 where hev (always for the simple filter)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    f2 = need & hev
    new_p0 = np.where(f2, np.clip(p0 + a2, 0, 255), p0)
    new_q0 = np.where(f2, np.clip(q0 - a1, 0, 255), q0)
    new_p1, new_q1, new_p2, new_q2 = p1, q1, p2, q2
    other = need & ~hev
    if other.any():
        if mode == "mb":  # DoFilter6
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            w1 = (27 * a + 63) >> 7
            w2 = (18 * a + 63) >> 7
            w3 = (9 * a + 63) >> 7
            new_p2 = np.where(other, np.clip(p2 + w3, 0, 255), p2)
            new_p1 = np.where(other, np.clip(p1 + w2, 0, 255), p1)
            new_p0 = np.where(other, np.clip(p0 + w1, 0, 255), new_p0)
            new_q0 = np.where(other, np.clip(q0 - w1, 0, 255), new_q0)
            new_q1 = np.where(other, np.clip(q1 - w2, 0, 255), q1)
            new_q2 = np.where(other, np.clip(q2 - w3, 0, 255), q2)
        else:  # DoFilter4
            a = 3 * (q0 - p0)
            b1 = np.clip((a + 4) >> 3, -16, 15)
            b2 = np.clip((a + 3) >> 3, -16, 15)
            b3 = (b1 + 1) >> 1
            new_p1 = np.where(other, np.clip(p1 + b3, 0, 255), p1)
            new_p0 = np.where(other, np.clip(p0 + b2, 0, 255), new_p0)
            new_q0 = np.where(other, np.clip(q0 - b1, 0, 255), new_q0)
            new_q1 = np.where(other, np.clip(q1 - b3, 0, 255), q1)
    P[1], P[2], P[3], P[4], P[5], P[6] = new_p2, new_p1, new_p0, new_q0, new_q1, new_q2


def _hfilter(img, y0, x, n, *args):
    """The vertical edge left of column x, rows y0..y0+n."""
    P = img[y0:y0 + n, x - 4:x + 4].T.copy()
    _filter_edge(P, *args)
    img[y0:y0 + n, x - 4:x + 4] = P.T


def _vfilter(img, y, x0, n, *args):
    """The horizontal edge above row y, columns x0..x0+n."""
    P = img[y - 4:y + 4, x0:x0 + n].copy()
    _filter_edge(P, *args)
    img[y - 4:y + 4, x0:x0 + n] = P


def _loop_filter(Y, U, V, info, filter_type):
    """DoFilter on every macroblock in raster order (the whole frame)."""
    # pad so that edges at the frame border can read 4 samples outside
    for mb_y, row in enumerate(info):
        for mb_x, (_, _, _, (limit, ilevel, hev), inner) in enumerate(row):
            if limit == 0:
                continue
            y0, x0 = 16 * mb_y, 16 * mb_x
            if filter_type == 1:
                if mb_x > 0:
                    _hfilter(Y, y0, x0, 16, 0, limit + 4, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _hfilter(Y, y0, x0 + k, 16, 0, limit, 0, "simple")
                if mb_y > 0:
                    _vfilter(Y, y0, x0, 16, 0, limit + 4, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _vfilter(Y, y0 + k, x0, 16, 0, limit, 0, "simple")
                continue
            cy, cx = 8 * mb_y, 8 * mb_x
            if mb_x > 0:
                _hfilter(Y, y0, x0, 16, hev, limit + 4, ilevel, "mb")
                _hfilter(U, cy, cx, 8, hev, limit + 4, ilevel, "mb")
                _hfilter(V, cy, cx, 8, hev, limit + 4, ilevel, "mb")
            if inner:
                for k in (4, 8, 12):
                    _hfilter(Y, y0, x0 + k, 16, hev, limit, ilevel, "inner")
                _hfilter(U, cy, cx + 4, 8, hev, limit, ilevel, "inner")
                _hfilter(V, cy, cx + 4, 8, hev, limit, ilevel, "inner")
            if mb_y > 0:
                _vfilter(Y, y0, x0, 16, hev, limit + 4, ilevel, "mb")
                _vfilter(U, cy, cx, 8, hev, limit + 4, ilevel, "mb")
                _vfilter(V, cy, cx, 8, hev, limit + 4, ilevel, "mb")
            if inner:
                for k in (4, 8, 12):
                    _vfilter(Y, y0 + k, x0, 16, hev, limit, ilevel, "inner")
                _vfilter(U, cy + 4, cx, 8, hev, limit, ilevel, "inner")
                _vfilter(V, cy + 4, cx, 8, hev, limit, ilevel, "inner")
