"""The port's OpenEXR reader (gd3d_torch/data/exr.py) held bit for bit
(compared as uint32, NaNs included) to OpenCV 4.6 + OpenEXR 3.1's
cv2.imread(f, IMREAD_ANYDEPTH), the live oracle of tests/exr_oracle.py (the
system interpreter's cv2, run with OPENCV_IO_ENABLE_OPENEXR=1; these tests
skip without it). OpenCV's writer makes lossy PXR24, B44(A) and DWAA/DWAB
files (R, G, B or Y, HALF or FLOAT), tests/exr_writer.py the rest, all from
seeds, in one batch per module (for a lossy chunk the writer's values are
no reference: OpenCV's array is):

  * channels: any subset of R, G, B, A, Y and Z, luminance-chroma names,
    HALF, FLOAT and UINT mixed, a chromaticities attribute (its x values
    are OpenCV's grey weights), infinities and NaNs;
  * x / y sampling of 2, 3 and 4 (OpenCV widens the grey channel in both
    axes, a colour channel in x on every line, a line without samples keeping
    the last one's, and G's sampling widens the grey image in y);
  * tiled files (every level mode, both roundings, every line order, tiles
    that do not divide the data window), multi-part files (part 0) and deep
    files (OpenCV returns None, the port raises exr.OpenCVRefuses);
  * every compression, multi-channel and subsampled, and OpenCV's lossy
    files with and without pLinear; the writer's B44(A) and DWA chunks add
    what OpenCV does not write (subsampled and mixed channels, alpha coded
    RLE, channels no rule claims, prefixed triples, deflated AC, files
    before version 2 and their legacy rules, tiles).

Also: the writer's one-Y files in every container read back in OpenCV to the
written values, so the port is never held to a writer that agrees only with
itself."""
import os
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_threads import one_torch_thread  # noqa: E402,F401
import exr_oracle  # noqa: E402
from exr_writer import set_plinear, write_deep, write_image, write_parts  # noqa: E402
from gd3d_torch.data import exr  # noqa: E402


def f(h, w, seed, dtype=np.float32, scale=10.0):
    """A seeded field of distinct values."""
    a = np.random.RandomState(seed).rand(h, w) * scale + 0.5
    return (a * 100).astype(dtype) if dtype == np.uint32 else a.astype(dtype)


H, W = 12, 16
R, G, B, A, Y = (f(H, W, s) for s in range(5))
CHROMA = (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.329)


def _cases():
    """name -> ("img", write_image keywords) | ("parts", [keywords], shared) |
    ("deep", tiled) | ("cv2", array, compression, type) |
    ("plinear", cv2 case, channels)."""
    c = {}
    img = lambda **kw: ("img", dict(compression=kw.pop("compression", "ZIP"), **kw))  # noqa
    for t, dt in (("f", np.float32), ("h", np.float16), ("u", np.uint32)):
        c[f"Y_{t}"] = img(channels={"Y": f(H, W, 1, dt)})
        c[f"Z_{t}"] = img(channels={"Z": f(H, W, 2, dt)})
        c[f"R_{t}"] = img(channels={"R": f(H, W, 3, dt)})
    c["Y_Z"] = img(channels={"Y": Y, "Z": A})
    c["Y_A"] = img(channels={"Y": Y, "A": A})
    c["Z_A"] = img(channels={"Z": Y, "A": A})
    for names in ("G", "B", "RG", "GB", "RB", "RGB", "RGBA", "RGBY", "BA"):
        c["ch_" + names] = img(channels={n: {"R": R, "G": G, "B": B, "A": A, "Y": Y}[n]
                                         for n in names})
    for names in ("A", "depth", "y", "r", "RY", "BY", "RY_BY", "left.Y", "Rr"):
        c["none_" + names] = img(channels={n: Y for n in names.split("_")})
    c["rgb_mixed"] = img(channels={"R": R.astype(np.float16), "G": f(H, W, 7, np.uint32),
                                   "B": B})
    c["rgb_uint"] = img(channels={n: f(H, W, k, np.uint32) for k, n in enumerate("RGB")})
    c["rgb_chroma"] = img(channels={"R": R, "G": G, "B": B}, chromaticities=CHROMA)
    c["y_chroma"] = img(channels={"Y": Y}, chromaticities=CHROMA)
    special = R.copy()
    special[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 1e-45, 3.4e38]
    c["rgb_special"] = img(channels={"R": special, "G": G, "B": -B})
    c["y_special"] = img(channels={"Y": special}, compression="PIZ")
    # sampling (the data window's width and height multiples of it)
    for name, xs, ys in (("x2", 2, 1), ("y2", 1, 2), ("xy2", 2, 2), ("x4y3", 4, 3)):
        hh, ww = 12, 16
        sub = f(hh // ys, ww // xs, 9)
        c[f"sub_Y_{name}"] = img(channels={"Y": sub}, sampling={"Y": (xs, ys)},
                                 compression="PIZ")
        for ch in "RGB":
            chans = {"R": R, "G": G, "B": B}
            chans[ch] = sub
            c[f"sub_{ch}_{name}"] = img(channels=chans, sampling={ch: (xs, ys)})
        c[f"sub_R_alone_{name}"] = img(channels={"R": sub}, sampling={"R": (xs, ys)},
                                       compression="RLE")
    c["sub_Y_x2_window_y"] = img(channels={"Y": f(H, W // 2, 11)}, sampling={"Y": (2, 1)},
                                 origin=(0, -5))
    c["sub_rgb_all_xy2"] = img(channels={n: f(H // 2, W // 2, k) for k, n in enumerate("RGB")},
                               sampling={n: (2, 2) for n in "RGB"}, compression="PIZ")
    c["sub_rgb_y2_window_y"] = img(channels={"R": R, "G": f(H // 2, W, 12), "B": B},
                                   sampling={"G": (1, 2)}, origin=(0, 4))
    c["sub_rgba_a_xy2"] = img(channels={"R": R, "G": G, "B": B, "A": f(H // 2, W // 2, 13)},
                              sampling={"A": (2, 2)})
    c["sub_Z_xy2"] = img(channels={"Z": f(H // 2, W // 2, 14)}, sampling={"Z": (2, 2)})
    c["window_rgb"] = img(channels={"R": R, "G": G, "B": B}, origin=(3, -5))
    c["window_y"] = img(channels={"Y": Y}, origin=(-7, 9), compression="PIZ", line_order=1)
    # tiled
    y = f(19, 27, 15)
    for mode in ("ONE_LEVEL", "MIPMAP", "RIPMAP"):
        for rnd in ("DOWN", "UP"):
            for order in (0, 1, 2):
                c[f"tiled_{mode}_{rnd}_{order}"] = img(
                    channels={"Y": y}, tiles=(8, 5, mode, rnd), line_order=order,
                    compression=("ZIP", "PIZ", "RLE")[order], origin=(-3, 4))
    c["tiled_rgb_big_tiles"] = img(channels={"R": R, "G": G, "B": B},
                                   tiles=(64, 64, "ONE_LEVEL", "DOWN"), compression="NONE")
    c["tiled_rgba_mixed"] = img(channels={"R": R.astype(np.float16), "G": f(H, W, 16, np.uint32),
                                          "B": B, "A": A}, tiles=(5, 7, "MIPMAP", "UP"),
                                compression="PXR24")
    c["tiled_pxr24_float"] = img(channels={"Y": y}, tiles=(16, 8, "ONE_LEVEL", "DOWN"),
                                 compression="PXR24")
    # multi-part
    c["parts_scan_tile"] = ("parts", [dict(channels={"Y": Y}, compression="ZIP"),
                                      dict(channels={"Y": 2 * Y},
                                           tiles=(8, 8, "ONE_LEVEL", "DOWN"))])
    c["parts_tile_scan"] = ("parts", [dict(channels={"Y": y}, compression="PIZ",
                                           tiles=(8, 8, "MIPMAP", "DOWN")),
                                      dict(channels={"R": R, "G": G, "B": B})])
    c["parts_one"] = ("parts", [dict(channels={"R": R, "G": G, "B": B}, compression="RLE")])
    c["parts_none"] = ("parts", [dict(channels={"depth": Y}), dict(channels={"Y": Y})])
    c["parts_unshared_display"] = ("parts", [dict(channels={"Y": Y}), dict(channels={"Y": y})],
                                   False)
    c["deep_scanline"] = ("deep", False)
    c["deep_tiled"] = ("deep", True)
    # the writer's compressions on several channels, sampled and mixed
    mixed = {"R": R, "G": f(H // 2, W // 2, 17, np.float16), "B": f(H, W // 4, 18, np.uint32),
             "A": A}
    sampling = {"G": (2, 2), "B": (4, 1)}
    for comp in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24"):
        c[f"comp_{comp}_mixed_sampled"] = img(channels=mixed, sampling=sampling,
                                              compression=comp, origin=(0, -2))
    c["comp_B44_float"] = img(channels={"R": R, "G": G, "B": B}, compression="B44")
    c["comp_PXR24_special"] = img(channels={"Y": special}, compression="PXR24")
    # the writer's B44(A) and DWA chunks: subsampled, mixed, pLinear, tiled,
    # alpha (RLE) and unclaimed (zlib) channels, prefixed triples, legacy rules
    h16 = lambda a: a.astype(np.float16)  # noqa
    r2, g2, b2 = (f(24, 32, s, scale=2.0) for s in (23, 24, 25))
    flat = np.full((13, 18), 2, np.float16)
    flat[5:, 9:] = 3
    flat[0, 0], flat[12, 17] = np.inf, np.nan
    for comp in ("B44", "B44A"):
        c[f"w{comp}_sampled"] = img(channels={"R": h16(r2), "G": h16(g2[::2, ::2]),
                                              "B": h16(b2[:, ::4]), "A": f(24, 32, 26, np.uint32)},
                                    sampling={"G": (2, 2), "B": (4, 1)}, compression=comp)
        c[f"w{comp}_flat_special"] = img(channels={"Y": flat}, compression=comp)
        c[f"w{comp}_plinear"] = img(channels={"Y": h16(r2), "R": h16(g2)}, compression=comp,
                                    p_linear=("Y", "R"))
        c[f"w{comp}_tiled"] = img(channels={"Y": h16(r2)}, compression=comp,
                                  tiles=(10, 6, "RIPMAP", "DOWN"))
    for comp in ("DWAA", "DWAB"):
        rgb16 = {"R": h16(r2), "G": h16(g2), "B": h16(b2)}
        c[f"w{comp}_rgb_alpha_unknown"] = img(channels={**rgb16, "G": g2, "A": h16(b2),
                                                        "Z": 3 * r2}, compression=comp)
        c[f"w{comp}_y_alpha_uint"] = img(channels={"Y": r2, "A": f(24, 32, 27, np.uint32),
                                                   "depth": h16(g2)}, compression=comp)
        c[f"w{comp}_sampled_triple"] = img(channels={k: v[::2, ::2] for k, v in rgb16.items()},
                                           sampling={k: (2, 2) for k in "RGB"}, compression=comp)
        c[f"w{comp}_sampled_mixed"] = img(channels={**rgb16, "G": h16(g2[::2, ::2]),
                                                    "Y": r2[:, ::4].copy()},
                                          sampling={"G": (2, 2), "Y": (4, 1)}, compression=comp)
        c[f"w{comp}_prefixed"] = img(channels={"left.R": h16(r2), "left.G": h16(g2),
                                               "left.B": h16(b2), "R": b2, "G": g2, "B": r2},
                                     compression=comp)
        c[f"w{comp}_ac_deflate"] = img(channels=rgb16, compression=comp, dwa={"ac": "deflate"})
        c[f"w{comp}_legacy"] = img(channels={"R": h16(r2), "g": h16(g2), "Blue": b2, "a": r2,
                                             "Y": h16(b2)}, compression=comp, dwa={"version": 1})
        c[f"w{comp}_y_plinear"] = img(channels={"Y": h16(r2)}, compression=comp,
                                      p_linear=("Y",))
        c[f"w{comp}_tiled"] = img(channels=rgb16, compression=comp,
                                  tiles=(24, 16, "MIPMAP", "UP"))
    # OpenCV's writer: the lossy compressions
    yy, xx = np.mgrid[0:40, 0:56]
    smooth = np.stack([2 + np.sin(yy / 5.0 + k) * np.cos(xx / 7.0) for k in range(3)], -1)
    noise = np.random.RandomState(19).randn(24, 40, 3) * 30
    for comp in ("PXR24", "B44", "B44A", "DWAA", "DWAB"):
        for typ in ("HALF", "FLOAT"):
            c[f"cv2_{comp}_{typ}_rgb"] = ("cv2", smooth.astype(np.float32), comp, typ)
            c[f"cv2_{comp}_{typ}_y"] = ("cv2", smooth[:37, :53, 0].astype(np.float32) * 50, comp,
                                        typ)
            c[f"cv2_{comp}_{typ}_noise"] = ("cv2", noise.astype(np.float32), comp, typ)
        c[f"cv2_{comp}_HALF_y_plinear"] = ("plinear", f"cv2_{comp}_HALF_y", None)
        c[f"cv2_{comp}_HALF_rgb_plinear_g"] = ("plinear", f"cv2_{comp}_HALF_rgb", {"G"})
    return c


CASES = _cases()
# files where OpenCV 4.6's array is not defined: the port refuses them by name
UNDEFINED = {
    "luminance_chroma": (dict(channels={"Y": Y, "RY": R, "BY": B}), "luminance-chroma"),
    "luminance_ry": (dict(channels={"Y": Y, "RY": R}), "luminance-chroma"),
    "sub_Y_window_x": (dict(channels={"Y": f(H // 2, W // 2, 20)}, sampling={"Y": (2, 2)},
                            origin=(4, 2)), "outside its buffer"),
    "sub_R_window_x": (dict(channels={"R": f(H, W // 2, 21), "G": G, "B": B},
                            sampling={"R": (2, 1)}, origin=(-4, 0)), "outside its buffer"),
}
WRITER_Y = {f"{comp}_{t}": (comp, dt) for comp in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24",
                                                    "B44")
            for t, dt in (("f", np.float32), ("h", np.float16), ("u", np.uint32))
            if not (comp == "B44" and dt == np.float16)}
WRITER_Y.update({f"tiled_{m}_{r}": ("ZIP", (m, r)) for m in ("ONE_LEVEL", "MIPMAP", "RIPMAP")
                 for r in ("DOWN", "UP")})
WRITER_Y["multipart"] = ("PIZ", "parts")


def _writer_y_values(comp, dt):
    a = f(23, 31, 22, dt if isinstance(dt, type) else np.float32)
    if comp == "PXR24" and a.dtype == np.float32:  # PXR24 keeps 24 bits of a FLOAT
        a = (a.view(np.uint32) & 0xFFFFFF00).view(np.float32)
    return a


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every case written and read by OpenCV once: name -> (path, OpenCV's
    array or None or exr_oracle.CRASH)."""
    o, why = exr_oracle.find()
    if o is None:
        pytest.skip(why)
    tmp = tmp_path_factory.mktemp("exr_oracle")
    paths = {}
    cv2_jobs = []
    for name, (kind, *how) in CASES.items():
        p = paths[name] = tmp / f"{name}.exr"
        if kind == "img":
            write_image(p, **how[0])
        elif kind == "parts":
            write_parts(p, *how)
        elif kind == "deep":
            write_deep(p, Y, tiled=how[0])
        elif kind == "cv2":
            cv2_jobs.append((how[0], p, how[1], how[2]))
    o.write(cv2_jobs)
    for name, (kind, *how) in CASES.items():
        if kind == "plinear":
            shutil.copy(paths[how[0]], paths[name])
            set_plinear(paths[name], how[1])
    for name, (comp, dt) in WRITER_Y.items():
        p = paths["writer_" + name] = tmp / f"writer_{name}.exr"
        a = _writer_y_values(comp, dt)
        if dt == "parts":
            write_parts(p, [dict(channels={"Y": a}, compression=comp),
                            dict(channels={"Y": a[:5]})])
        elif isinstance(dt, tuple):
            write_image(p, {"Y": a}, compression=comp, tiles=(8, 6) + dt)
        else:
            write_image(p, {"Y": a}, compression=comp)
    names = sorted(paths)
    return dict(zip(names, zip((paths[n] for n in names),
                               o.read([paths[n] for n in names]))))


def assert_bits_equal(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_equals_opencv(built, name):
    path, want = built[name]
    if want is None:
        with pytest.raises(exr.OpenCVRefuses) as err:
            exr.read_exr(path)
        assert str(path) in str(err.value)
        return
    assert isinstance(want, np.ndarray), want
    assert_bits_equal(exr.read_exr(path), want)


def test_lossy_cases_hold_coded_blocks(built):
    """The smooth lossy files are coded (PXR24, B44, DWA chunks smaller than
    raw), so that the decoders under test are the ones that ran."""
    for name, (kind, *how) in CASES.items():
        if kind == "cv2" and how[2] == "HALF" and "noise" not in name:
            data = built[name][0].read_bytes()
            attrs, pos = exr._header(data, name)
            assert exr.COMPRESSIONS[attrs["compression"][1][0]] == how[1]
            assert len(data) < how[0].size * 2, name


@pytest.mark.parametrize("name", sorted(WRITER_Y))
def test_writer_y_files_read_back_in_opencv(built, name):
    """OpenCV reads the writer's one-Y files (every compression and type it
    writes losslessly, tiled and multi-part) back to the written values."""
    comp, dt = WRITER_Y[name]
    _, got = built["writer_" + name]
    assert isinstance(got, np.ndarray), got
    assert_bits_equal(got, _writer_y_values(comp, dt).astype(np.float32))


@pytest.mark.parametrize("name", sorted(UNDEFINED))
def test_port_refuses_what_opencv_leaves_undefined(tmp_path, name):
    """Luminance-chroma files (OpenCV's grey is uninitialised memory) and
    subsampled channels with the data window off 0 in that axis (OpenCV
    writes outside its buffer, or crashes): a ValueError naming the file,
    not OpenCVRefuses, so that read_depth_float does not hide them."""
    kw, match = UNDEFINED[name]
    path = tmp_path / "u.exr"
    write_image(path, compression="ZIP", **kw)
    with pytest.raises(ValueError, match=match) as err:
        exr.read_exr(path)
    assert not isinstance(err.value, exr.OpenCVRefuses) and str(path) in str(err.value)


def test_committed_fixtures_are_opencvs_arrays():
    """The digests tests/test_torch_formats_wiring.py and chip_smoke.py hold
    the port to are OpenCV's: every committed EXR fixture (the "exr_cv" set
    and the writer's older "exr" three) read by the live oracle gives its
    digest, or None where the digest is null."""
    import hashlib
    import json

    o, why = exr_oracle.find()
    if o is None:
        pytest.skip(why)
    data = os.path.join(ROOT, "gd3d_torch", "data", "testdata")
    digests = json.load(open(os.path.join(data, "formats", "digests.json")))
    files = [(os.path.join(data, "exr", n), d) for n, d in sorted(digests["exr_cv"].items())]
    files += [(os.path.join(data, "formats", n), d) for n, d in sorted(digests["exr"].items())]
    for (path, want), got in zip(files, o.read([p for p, _ in files])):
        assert (None if got is None else hashlib.sha256(got.tobytes()).hexdigest()) == want, path
