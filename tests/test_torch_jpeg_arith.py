"""The JPEG kinds that gd3d opens through PIL and that no tool here writes,
decoded by gd3d_torch/data/jpeg.py and held to PIL bit for bit (tolerance 0)
on files from tests/torch_jpeg_writer.py: arithmetic-coded sequential
(SOF9) and progressive (SOF10) files, lossless files (SOF3), and
libjpeg-turbo's block smoothing of progressive files whose scans leave a
low-frequency coefficient unrefined. decode_jpeg must give PIL's
Image.open(f).convert("RGB") and jpeg_size PIL's .size.

The writer's self-checks make PIL an oracle that does not trust the writer:
PIL's RGB of an arithmetic file equals PIL's RGB of jpeg_encode's Huffman
file of the same coefficients and quantisers, and PIL's array of a lossless
file with no colour transform or subsampling is the source with its low Pt
bits cleared. The probes show what stays refused: PIL raises on the same
bytes, and the port raises a ValueError naming the file and the feature."""
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_jpeg_writer as W  # noqa: E402
from gd3d_torch.data.jpeg import decode_jpeg, jpeg_size  # noqa: E402
from test_torch_jpeg import texture  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RGB = W.texture(48, 64, 1)
FACTORS = {"444": None, "420": W.F420, "422": [(2, 1), (1, 1), (1, 1)]}


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(data):
    got, want = decode_jpeg(data), _pil(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert jpeg_size(data) == Image.open(io.BytesIO(data)).size


def _frame(kind, rgb=RGB):
    if kind == "gray":
        return W.dct_frame([rgb[..., 0]])
    if kind == "cmyk":
        return W.dct_frame(list(np.moveaxis(W.texture(*rgb.shape[:2], 42, c=4), -1, 0)))
    return W.dct_frame(W.ycc(rgb), FACTORS[kind])


def _dct(kind, **kw):
    return W.write_dct(_frame(kind), adobe=0 if kind == "cmyk" else None, **kw)


SEQUENTIAL = {"plain": {}, "restart": dict(restart=3), "dac": dict(cond=W.NONDEFAULT),
              "separate": dict(separate=True, restart=5)}


@pytest.mark.parametrize("opts", sorted(SEQUENTIAL))
@pytest.mark.parametrize("kind", ["gray", "444", "420", "422", "cmyk"])
def test_arithmetic_sequential_matches_pil(kind, opts):
    """SOF9: one interleaved scan (or one a component), restart intervals,
    non-default conditioning (DAC: DC L and U, AC Kx)."""
    _check(_dct(kind, arith=True, **SEQUENTIAL[opts]))


@pytest.mark.parametrize("script", ["default", "successive"])
@pytest.mark.parametrize("kind", ["gray", "420", "422"])
def test_arithmetic_progressive_matches_pil(kind, script):
    """SOF10: libjpeg-turbo's default script, and one with successive
    approximation in both DC and AC (refinement from Al 2 and 3) and
    restarts."""
    n = 1 if kind == "gray" else 3
    if script == "default":
        _check(_dct(kind, arith=True, script=W.simple_progression(n)))
    else:
        _check(_dct(kind, arith=True, script=W.successive_script(n), restart=5,
                    cond=W.NONDEFAULT))


@pytest.mark.parametrize("kind", ["gray", "444", "420", "cmyk"])
@pytest.mark.parametrize("script", ["default", "successive"])
def test_arithmetic_files_equal_their_huffman_twin(kind, script):
    """Writer self-check: PIL decodes the arithmetic file of a frame to the
    RGB of jpeg_encode's baseline Huffman file of the same coefficients."""
    frame = _frame(kind)
    n = len(frame["comps"])
    data = W.write_dct(frame, arith=True, script=W.simple_progression(n) if script == "default"
                       else W.successive_script(n), adobe=0 if kind == "cmyk" else None)
    np.testing.assert_array_equal(_pil(data), _pil(W.baseline_twin(frame)))
    np.testing.assert_array_equal(_pil(W.write_dct(frame, arith=True, adobe=0 if kind == "cmyk"
                                                   else None)), _pil(W.baseline_twin(frame)))


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("ncomp", [1, 3])
def test_lossless_matches_pil(ncomp, psv, pt, restart):
    """SOF3: predictors 1-7 x Pt 0 and 2, with and without restarts (the
    first row and column again after each); three components carry an
    Adobe marker of transform 0 where there are restarts, none otherwise.
    Writer self-check: PIL's samples are the source's with the low Pt bits
    cleared."""
    planes = list(np.moveaxis(RGB, -1, 0))[:ncomp]
    adobe = 0 if ncomp == 3 and restart else None
    data = W.write_lossless(planes, psv=psv, pt=pt, restart_rows=restart, adobe=adobe)
    _check(data)
    want = (np.stack(planes, -1) >> pt) << pt
    got = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("factors,kw", [
    ([(2, 2), (1, 1), (1, 1)], {}),
    ([(2, 1), (1, 1), (1, 1)], dict(adobe=0, psv=4, restart_rows=3)),
    ([(1, 2), (1, 1), (1, 1)], dict(psv=7, pt=1)),
    ([(1, 1), (1, 1), (1, 1)], dict(psv=5)),
    ([(1, 1), (1, 1), (1, 1)], dict(separate=True, psv=6, restart_rows=4)),
    ([(2, 2), (1, 1), (1, 1)], dict(separate=True, psv=3, restart_rows=3)),
    ([(1, 2), (1, 1), (1, 1)], dict(separate=True, psv=7, pt=3)),
    ("cmyk", {}),
    ("cmyk", dict(adobe=0, psv=2, restart_rows=2)),
])
def test_lossless_sampling_and_markers_match_pil(factors, kw):
    """Subsampled lossless planes (libjpeg-turbo replicates them: its fancy
    upsampling needs DCT blocks), no marker taken as RGB, one scan a
    component (a restart inside a 2-row iMCU row of Y restarts the
    prediction at that iMCU row's first row, as jddiffct.c undoes it, not
    at the restart's own row), and four components (CMYK)."""
    if factors == "cmyk":
        _check(W.write_lossless(list(np.moveaxis(W.texture(47, 61, 42, c=4), -1, 0)), **kw))
    else:
        _check(W.write_lossless(list(np.moveaxis(RGB[:47, :61], -1, 0)), factors, **kw))


def _drop_scans(data, k):
    for _ in range(k):
        i = data.rindex(b"\xff\xda")
        data = data[:i] + b"\xff\xd9"
    return data


def _pil_progressive(hw, gray):
    img = texture(*hw, seed=hw[0] + hw[1])
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if gray else img).save(buf, "JPEG", progressive=True,
                                                       subsampling=2)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(48, 64), (41, 16)])
@pytest.mark.parametrize("gray,k", [(False, k) for k in range(1, 10)]
                         + [(True, k) for k in range(1, 6)])
def test_block_smoothing_matches_pil(hw, gray, k):
    """PIL's progressive 4:2:0 (10 scans) and grey (6 scans) files with
    their last k scans dropped, every k that leaves the DC scan: with only
    the DC scan the 5x5 DC interpolation (no AC coded), after the first AC
    scan the estimate of the unrefined AC coefficients; a component two
    blocks wide clamps its window to its blocks."""
    full = _pil_progressive(hw, gray)
    assert full.count(b"\xff\xda") == (6 if gray else 10)
    _check(_drop_scans(full, k))


@pytest.mark.parametrize("h", [17, 25, 41, 57])
@pytest.mark.parametrize("factors", [W.F420, [(1, 2), (1, 2), (1, 1)], [(2, 2), (1, 2), (2, 1)]])
def test_block_smoothing_window_rows_match_pil(h, factors):
    """The rows of the smoothing window near the bottom, iMCU row by iMCU
    row as libjpeg-turbo takes them: dummy blocks below the image given DC
    values of their own, so a window that reads them shows."""
    frame = W.dct_frame(W.ycc(W.texture(h, 40, h)), factors)
    for c in frame["comps"]:
        c["coef"][c["bh"]:, :, 0] += 7
    for script in (W.simple_progression(3)[:1], W.simple_progression(3)[:4]):
        _check(W.write_dct(frame, script=script))


@pytest.mark.parametrize("case", ["arith_dc_only", "huffman_dc_al0", "no_smoothing",
                                  "arith_partial"])
def test_written_progressive_scripts_match_pil(case):
    """Scripts dropping scans cannot reach: a DC scan alone at Al 0 (its DC
    still interpolated), an arithmetic file stopped after its first AC
    scans, and a script that refines AC only past coefficient 9, which
    must not smooth."""
    rgb = W.texture(64, 80, 3)
    if case == "arith_dc_only":
        data = W.write_dct(W.dct_frame([rgb[..., 0]]), arith=True,
                           script=W.simple_progression(1)[:1])
    elif case == "huffman_dc_al0":
        data = W.write_dct(W.dct_frame(W.ycc(rgb), W.F420), script=[((0, 1, 2), 0, 0, 0, 0)])
    elif case == "no_smoothing":
        frame = W.dct_frame(W.ycc(rgb), W.F420)
        data = W.write_dct(frame, script=W.NO_SMOOTH_SCRIPT)
        for c in frame["comps"]:  # what the file holds: coefficients 10-63 cut to Al 1
            ac = c["coef"][..., 10:]
            c["coef"] = c["coef"].copy()
            c["coef"][..., 10:] = np.sign(ac) * (np.abs(ac) >> 1 << 1)
        np.testing.assert_array_equal(_pil(data), _pil(W.baseline_twin(frame)))
    else:
        data = W.write_dct(W.dct_frame(W.ycc(rgb), W.F420), arith=True,
                           script=W.simple_progression(3)[:6])
    _check(data)


PROBES = {
    "hierarchical": (lambda: W.hierarchical_probe(RGB), "hierarchical"),
    "fractional": (lambda: W.fractional_probe(RGB), "fractional sampling"),
    "sof11": (lambda: W.sof11_probe(RGB), "arithmetic-coded lossless"),
    "lossless_jfif": (lambda: W.write_lossless(list(np.moveaxis(RGB, -1, 0)), jfif=True),
                      "colour transform"),
    "lossless_adobe_ycc": (lambda: W.write_lossless(list(np.moveaxis(RGB, -1, 0)), adobe=1),
                           "colour transform"),
    "lossless_ycck": (lambda: W.write_lossless(list(np.moveaxis(W.texture(48, 64, 42, c=4), -1,
                                                                0)), adobe=2),
                      "colour transform"),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_refused_kinds_are_refused_by_pil_too(tmp_path, probe):
    """Parity: PIL (libjpeg-turbo) opens the header and raises on load; the
    port raises a ValueError naming the file and the feature: hierarchical
    files, fractional sampling, arithmetic-coded lossless, and colour
    conversion of a lossless file."""
    make, what = PROBES[probe]
    path = tmp_path / f"{probe}.jpg"
    path.write_bytes(make())
    with pytest.raises(OSError):
        Image.open(path).load()
    with pytest.raises(ValueError, match=what) as err:
        decode_jpeg(path)
    assert str(path) in str(err.value)
