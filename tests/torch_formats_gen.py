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
    disparity and flow.

    PYTHONPATH=. python tests/torch_formats_gen.py

writes them anew (PIL, cv2, h5py and gd3d needed)."""
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


def main():
    import h5py
    from PIL import Image

    import gd3d.data.flowio as gflow
    from gd3d.data.images import load_image_mast3r
    from exr_writer import write_exr

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "views").mkdir(exist_ok=True)
    digests = {"image": {}, "view": {}, "exr": {}, "hdf5": {}, "flowio": {}}
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
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT}: {sum(len(v) for v in digests.values())} fixtures, {total} bytes")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
