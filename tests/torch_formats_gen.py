"""The committed file-format fixtures of gd3d_torch/data/testdata/formats/ and
their digests (digests.json there), which chip_smoke.py's formats phase
decodes on the card's machine (no PIL, cv2 or h5py there) and
tests/test_torch_formats_wiring.py holds to the libraries here:

  * images: a progressive 854x480 4:2:0 JPEG, CMYK, YCCK and 4:1:1 JPEGs,
    lossy, lossless and alpha WebPs (512x384 for the first two), RLE8,
    5-6-5 and 32-bit BMPs, an Adam7 and a 2-bit PNG; digest: the SHA-256 of
    PIL's np.asarray(Image.open(f).convert("RGB"));
  * views/: the four align views (a progressive JPEG, a lossy WebP, a
    24-bit BMP, an Adam7 PNG; 128x96 windows of one texture); digest:
    gd3d's load_image_mast3r(f, 512)["img"] (the [-1, 1] float32 array);
  * EXR depth (ZIP float32, PIZ float16, RLE float32); digest: the written
    values as float32 (tests/exr_writer.py writes them);
  * HDF5: MegaDepth-style "depth" at h5py's default format and at
    libver="latest", a "disparity" .h5 and a "flow" .flo5 with NaNs;
    digest: h5py's array, and gd3d's flowio reads (NaN -> +inf) of the
    disparity and flow;
  * more HDF5 (digests under "hdf5_more", keyed "file#dataset"): the
    filters (lzf, szip, n-bit, scale-offset), types (nested compound,
    space-padded and variable-length strings, enum, array),
    links (soft, external, dense storage) and external storage that
    tests/test_torch_hdf5.py::write_case writes; digest:
    `h5_digest` of h5py's dset[()] (object arrays element by element);
  * animated WebPs (frame 0 on its canvas: PIL's save_all with alpha, and
    ANMF frames at offsets assembled by tests/test_torch_webp.py), under
    "image" with PIL's digest;
  * "jpeg_writer": no files, only digests of tests/torch_jpeg_writer.py's
    fixture_files() (arithmetic-coded sequential and progressive, lossless
    and block-smoothed JPEGs, three of them 512x384), which the formats
    phase writes again from their fixed seeds: the SHA-256 of each file's
    bytes ("file") and of PIL's RGB ("rgb").

    PYTHONPATH=. python tests/torch_formats_gen.py

writes them anew (PIL, cv2, h5py and gd3d needed); with --jpeg-writer it
rewrites the "jpeg_writer" digests alone (PIL needed)."""
import hashlib
import io
import json
import os
import struct
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

OUT = ROOT / "gd3d_torch" / "data" / "testdata" / "formats"
VIEW_HW = (96, 128)


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def texture(h, w, seed, c=3, noise=6.0):
    """A smooth multi-scale colour texture, little noise: small files."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, c))
    for cell, amp in ((96, 70.0), (24, 40.0), (6, 15.0)):
        low = rng.randn(h // cell + 2, w // cell + 2, c)
        ys, xs = np.arange(h) / cell, np.arange(w) / cell
        y0, x0 = ys.astype(int), xs.astype(int)
        ty, tx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        img += amp * ((low[y0][:, x0] * (1 - tx) + low[y0][:, x0 + 1] * tx) * (1 - ty)
                      + (low[y0 + 1][:, x0] * (1 - tx) + low[y0 + 1][:, x0 + 1] * tx) * ty)
    img += rng.randn(h, w, c) * noise
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def depth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    d = 2.0 + np.sin(yy / 17.0 + seed) + np.cos(xx / 23.0)
    d = np.round(d * 256) / 256
    d[h // 4:h // 3, w // 5:w // 4] = 0
    return d.astype(np.float32)


def _pil_bytes(arr_or_im, fmt, **kw):
    from PIL import Image

    im = arr_or_im if isinstance(arr_or_im, Image.Image) else Image.fromarray(arr_or_im)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def image_files() -> dict:
    import cv2
    from PIL import Image

    from test_torch_bmp import pack_bmp
    from test_torch_png import encode_png

    files = {}
    files["progressive_854x480.jpg"] = _pil_bytes(texture(480, 854, 1), "JPEG", quality=85,
                                                  subsampling=2, progressive=True)
    cmyk = _pil_bytes(Image.fromarray(texture(48, 64, 2)).convert("CMYK"), "JPEG", quality=85)
    files["cmyk.jpg"] = cmyk
    i = cmyk.index(b"Adobe")
    files["ycck.jpg"] = cmyk[:i + 11] + b"\x02" + cmyk[i + 12:]
    files["s411.jpg"] = cv2.imencode(".jpg", texture(48, 72, 3), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes()
    files["lossy_512x384.webp"] = _pil_bytes(texture(384, 512, 4), "WEBP", quality=80)
    files["lossless_512x384.webp"] = _pil_bytes(texture(384, 512, 5, noise=0.0) // 8 * 8, "WEBP",
                                                lossless=True)
    rgba = texture(48, 64, 6, c=4)
    rgba[:8, :8, 3] = 0
    files["alpha.webp"] = _pil_bytes(rgba, "WEBP", quality=75)
    idx = np.random.RandomState(7).randint(0, 200, (24, 33)).astype(np.uint8)
    pal = np.random.RandomState(8).randint(0, 256, (256, 3))
    rle = bytearray()
    for y in range(24):
        r = idx[23 - y]
        rle += bytes([9, r[0]]) + bytes([0, 5]) + bytes(r[9:14]) + b"\x00"
        rle += bytes([19, r[14]]) + b"\x00\x00"
    files["rle8.bmp"] = pack_bmp(bytes(rle[:-2] + b"\x00\x01"), 33, 24, 8, compression=1,
                                 palette=pal)
    p565 = np.random.RandomState(9).randint(0, 1 << 16, (24, 33)).astype("<u2")
    files["bitfields565.bmp"] = pack_bmp([r.tobytes() for r in p565[::-1]], 33, 24, 16,
                                         compression=3, masks=(0xF800, 0x7E0, 0x1F))
    files["bgra32_v5.bmp"] = pack_bmp(
        [r.tobytes() for r in np.ascontiguousarray(texture(24, 33, 10, c=4)[::-1][..., [2, 1, 0,
                                                                                    3]])],
        33, 24, 32, 124, compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["adam7.png"] = encode_png(texture(37, 45, 11), 2, 8, (0, 1, 2, 3, 4), interlace=1)
    files["gray2.png"] = encode_png(texture(37, 45, 12)[..., :1] >> 6, 0, 2, (4, 1))
    return files


def view_files() -> dict:
    from test_torch_png import encode_png

    big = texture(VIEW_HW[0] + 24, VIEW_HW[1] + 24, 13)
    h, w = VIEW_HW
    crops = [big[dy:dy + h, dx:dx + w] for dx, dy in ((0, 0), (5, 3), (11, 7), (17, 11))]
    bgr = crops[2][::-1, :, ::-1]
    bmp = (b"BM" + struct.pack("<IHHI", 54 + bgr.size, 0, 0, 54)
           + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, bgr.size, 2835, 2835, 0, 0)
           + bgr.tobytes())
    return {"view_0.jpg": _pil_bytes(crops[0], "JPEG", quality=90, progressive=True),
            "view_1.webp": _pil_bytes(crops[1], "WEBP", quality=85),
            "view_2.bmp": bmp,
            "view_3.png": encode_png(crops[3], 2, 8, (1, 4), interlace=1)}


# tests/test_torch_hdf5.py::MORE_CASES written as fixtures, on a small array
# (the CPU tests hold the other cases; 4-byte offsets and sequences would
# take ~13 KB more of test_torch_formats_wiring.py's 400 KB)
HDF5_MORE = ("lzf", "szip_f4", "szip_i2", "nbit_i31", "scaleoffset", "scaleoffset_float",
             "compound_nested", "string_spacepad", "vlen_str", "enum", "array", "soft_link",
             "external_link", "dense_links", "external_storage")
ANIM_WEBP = ("pil_rgba", "offset_alph", "offset_lossless")


def h5_digest(a) -> str:
    """The SHA-256 of an array as h5py returns it: its dtype and shape, then
    its bytes, or, for an object array, each element's (bytes, or an
    array's dtype and bytes)."""
    def plain(dt):  # the dtype without h5py's metadata
        if dt.names:
            return [(n, plain(dt.fields[n][0]), dt.fields[n][1]) for n in dt.names]
        return [plain(dt.subdtype[0]), dt.subdtype[1]] if dt.subdtype else dt.str

    h = hashlib.sha256(f"{plain(a.dtype)} {a.dtype.itemsize} {a.shape}".encode())
    if a.dtype != object:
        h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()
    for x in a.reshape(-1):
        if isinstance(x, np.ndarray):
            h.update(f"{x.dtype.str} {x.shape}".encode() + x.tobytes())
        else:
            h.update(len(x).to_bytes(8, "little") + x)
    return h.hexdigest()


def more_hdf5(digests) -> None:
    import h5py

    from test_torch_hdf5 import write_case

    data = np.random.RandomState(17).rand(12, 10, 2).astype(np.float32)
    cwd = os.getcwd()
    os.chdir(OUT)  # external storage is named from the working directory
    try:
        for what in HDF5_MORE:
            name = write_case(OUT / f"{what}.h5", what, data)
            with h5py.File(OUT / f"{what}.h5") as f:
                digests["hdf5_more"][f"{what}.h5#{name}"] = h5_digest(f[name][()])
    finally:
        os.chdir(cwd)


def anim_webp(digests) -> None:
    import tempfile

    from PIL import Image

    from test_torch_webp import anim_case

    with tempfile.TemporaryDirectory() as tmp:
        for case in ANIM_WEBP:
            name = f"anim_{case}.webp"
            (OUT / name).write_bytes(anim_case(case, Path(tmp)).read_bytes())
            digests["image"][name] = sha(np.asarray(Image.open(OUT / name).convert("RGB")))


def jpeg_writer(digests) -> None:
    from PIL import Image

    from torch_jpeg_writer import fixture_files

    digests["jpeg_writer"] = {
        name: {"file": hashlib.sha256(data).hexdigest(),
               "rgb": sha(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))}
        for name, data in sorted(fixture_files().items())}


EXR_OUT = ROOT / "gd3d_torch" / "data" / "testdata" / "exr"
EXR_TIMED = ("dwaa_rgb_512x384.exr", "b44_rgb_512x384.exr", "pxr24_rgb_512x384.exr")


def field(h, w, seed, c=0, scale=4.0):
    """A smooth seeded float32 field (c channels, or (h, w) for c=0) around
    `scale`, with a hole of zeros."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.RandomState(seed)
    out = []
    for k in range(max(c, 1)):
        fy, fx, py, px = rng.uniform(5, 40, 2).tolist() + rng.uniform(0, 6, 2).tolist()
        out.append(scale * (1.0 + 0.5 * np.sin(yy / fy + py) * np.cos(xx / fx + px)))
    a = np.stack(out, -1) if c else out[0]
    a[h // 4:h // 3, w // 5:w // 4] = 0
    return a.astype(np.float32)


def exr_fixture_jobs():
    """The EXR fixtures: name -> ("cv2", array, compression, type) for
    OpenCV's writer, ("writer", function, keywords) for tests/exr_writer.py,
    or ("plinear", cv2 fixture, channels) for a copy with pLinear set."""
    from exr_writer import write_deep, write_image, write_parts

    h, w = 48, 64
    rgb, y = field(h, w, 1, 3), field(h, w, 2)
    jobs = {}
    for comp, typ in (("PXR24", "HALF"), ("PXR24", "FLOAT"), ("B44", "HALF"), ("B44A", "HALF"),
                      ("B44", "FLOAT"), ("DWAA", "HALF"), ("DWAB", "FLOAT")):
        jobs[f"{comp.lower()}_rgb_{typ.lower()}.exr"] = ("cv2", rgb, comp, typ)
        jobs[f"{comp.lower()}_y_{typ.lower()}.exr"] = ("cv2", y[:37, :53].copy(), comp, typ)
    big = field(384, 512, 3, 3)
    for name in EXR_TIMED:
        jobs[name] = ("cv2", big, name.split("_")[0].upper(), "HALF")
    jobs["b44_rgb_half_plinear.exr"] = ("plinear", "b44_rgb_half.exr", None)
    jobs["dwaa_rgb_half_plinear.exr"] = ("plinear", "dwaa_rgb_half.exr", None)
    jobs["dwaa_y_half_plinear.exr"] = ("plinear", "dwaa_y_half.exr", None)
    r, g, b = (field(h, w, s) for s in (4, 5, 6))
    jobs["rgba_mixed_zip.exr"] = ("writer", write_image, dict(
        channels={"R": r.astype(np.float16), "G": (g * 100).astype(np.uint32), "B": b,
                  "A": field(h, w, 7).astype(np.float16)}, compression="ZIP", origin=(-3, 5)))
    jobs["chroma_rgb_piz.exr"] = ("writer", write_image, dict(
        channels={"R": r, "G": g, "B": b}, compression="PIZ",
        chromaticities=(0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.329)))
    jobs["sub_y_xy2_piz.exr"] = ("writer", write_image, dict(
        channels={"Y": y[::2, ::2].astype(np.float16)}, compression="PIZ",
        sampling={"Y": (2, 2)}))
    jobs["sub_rgb_zip.exr"] = ("writer", write_image, dict(
        channels={"R": r, "G": g[::2], "B": b[::2, ::2]}, compression="ZIP",
        sampling={"G": (1, 2), "B": (2, 2)}, origin=(0, -6)))
    jobs["z_only_rle.exr"] = ("writer", write_image, dict(channels={"Z": y}, compression="RLE"))
    jobs["tiled_mipmap_piz.exr"] = ("writer", write_image, dict(
        channels={"Y": y}, compression="PIZ", tiles=(24, 20, "MIPMAP", "DOWN"), origin=(7, -2)))
    jobs["tiled_ripmap_up_zip.exr"] = ("writer", write_image, dict(
        channels={"Y": y[:45, :59].copy()}, compression="ZIP", tiles=(16, 16, "RIPMAP", "UP"),
        line_order=2))
    jobs["tiled_rgb_rle.exr"] = ("writer", write_image, dict(
        channels={"R": r, "G": g, "B": b}, compression="RLE", tiles=(32, 32, "ONE_LEVEL", "DOWN"),
        line_order=1))
    jobs["multipart.exr"] = ("writer", write_parts, [
        dict(channels={"Y": y}, compression="PIZ", tiles=(16, 16, "ONE_LEVEL", "DOWN")),
        dict(channels={"R": r, "G": g, "B": b}, compression="ZIP")])
    jobs["deep_scanline.exr"] = ("writer", write_deep, dict(array=y[:8, :12]))
    jobs["channel_depth.exr"] = ("writer", write_image, dict(channels={"depth": y},
                                                             compression="ZIP"))
    return jobs


def exr_fixtures(digests) -> None:
    """Writes the EXR fixtures and records, under "exr_cv", the SHA-256 of
    OpenCV's float32 cv2.imread(f, IMREAD_ANYDEPTH), or null where it
    returns None; checks the "exr" digests against OpenCV too."""
    import shutil

    from exr_oracle import find
    from exr_writer import set_plinear

    o, why = find()
    if o is None:
        raise SystemExit(f"the EXR fixtures need the OpenCV 4.6 oracle: {why}")
    if EXR_OUT.exists():
        shutil.rmtree(EXR_OUT)
    EXR_OUT.mkdir(parents=True)
    jobs = exr_fixture_jobs()
    o.write([(job[1], EXR_OUT / name, *job[2:]) for name, job in jobs.items()
             if job[0] == "cv2"])
    for name, (kind, *how) in jobs.items():
        if kind == "plinear":
            shutil.copy(EXR_OUT / how[0], EXR_OUT / name)
            set_plinear(EXR_OUT / name, how[1])
        elif kind == "writer":
            fn, kw = how
            fn(EXR_OUT / name, kw) if isinstance(kw, list) else fn(EXR_OUT / name, **kw)
    names = sorted(jobs)
    got = o.read([EXR_OUT / n for n in names])
    digests["exr_cv"] = {n: None if a is None else sha(a) for n, a in zip(names, got)}
    old = o.read([OUT / n for n in sorted(digests["exr"])])
    for n, a in zip(sorted(digests["exr"]), old):
        if a is None or sha(a) != digests["exr"][n]:
            raise SystemExit(f"OpenCV disagrees with the committed digest of {n}")


def main():
    import h5py
    from PIL import Image

    import gd3d.data.flowio as gflow
    from gd3d.data.images import load_image_mast3r
    from exr_writer import write_exr

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "views").mkdir(exist_ok=True)
    digests = {"image": {}, "view": {}, "exr": {}, "hdf5": {}, "flowio": {}, "hdf5_more": {}}
    for name, data in sorted(image_files().items()):
        (OUT / name).write_bytes(data)
        digests["image"][name] = sha(np.asarray(Image.open(OUT / name).convert("RGB")))
    for name, data in sorted(view_files().items()):
        (OUT / "views" / name).write_bytes(data)
        digests["view"][name] = sha(load_image_mast3r(str(OUT / "views" / name), 512)["img"])
    for name, arr, comp in (("depth_zip.exr", depth(48, 64, 0), "ZIP"),
                            ("depth_piz_half.exr", depth(40, 56, 1).astype(np.float16), "PIZ"),
                            ("depth_rle.exr", depth(33, 47, 2), "RLE")):
        write_exr(OUT / name, arr, comp)
        digests["exr"][name] = sha(arr.astype(np.float32))
    d = depth(60, 80, 3)
    for name, libver in (("depth_default.h5", "earliest"), ("depth_latest.h5", "latest")):
        with h5py.File(OUT / name, "w", libver=libver) as f:
            f.create_dataset("depth", data=d, compression="gzip", shuffle=libver == "latest",
                             chunks=(16, 32))
        with h5py.File(OUT / name) as f:
            digests["hdf5"][name] = sha(np.asarray(f["depth"]))
    disp = depth(30, 40, 4) * 20
    disp[2, :5] = np.nan
    with h5py.File(OUT / "disp.h5", "w") as f:
        f.create_dataset("disparity", data=disp)
    flow = np.stack([depth(30, 40, 5), -depth(30, 40, 6)], -1) * 3
    flow[4, 4] = np.nan
    with h5py.File(OUT / "flow.flo5", "w") as f:
        f.create_dataset("flow", data=flow, compression="gzip", compression_opts=5)
    digests["flowio"]["disp.h5"] = sha(gflow.read_gt(str(OUT / "disp.h5"), "stereo"))
    digests["flowio"]["flow.flo5"] = sha(gflow.read_gt(str(OUT / "flow.flo5"), "flow"))
    more_hdf5(digests)
    anim_webp(digests)
    jpeg_writer(digests)
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT}: {sum(len(v) for v in digests.values())} fixtures, {total} bytes")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if sys.argv[1:] in (["--jpeg-writer"], ["--exr"]):
        kept = json.loads((OUT / "digests.json").read_text())
        (jpeg_writer if sys.argv[1] == "--jpeg-writer" else exr_fixtures)(kept)
        (OUT / "digests.json").write_text(json.dumps(kept, indent=1, sort_keys=True) + "\n")
    else:
        main()
