"""Visual-debug dumps to disk (counterpart of gd3d/utils/vis.py), in numpy:
no cv2 and no matplotlib. The same four functions, file names and image
sizes as gd3d's.

  * `vis_attn_map` and `visualize_tracking_results` give the pixels of
    gd3d's cv2 files: the attention rows upsampled as cv2.resize does
    (data/resample.py), OpenCV's JET table, cv2.circle's filled disc of
    radius 3 (its 29-pixel mask, clipped at the borders), and the port's
    JPEG encoder at cv2.imwrite's defaults (quality 95, 4:2:0), whose bytes
    equal cv2's.
  * `visualize_matching_pairs` and `visualize_depth_maps` redraw gd3d's
    matplotlib figures (1500 x 500 RGBA PNGs, the port's PNG encoder) panel
    by panel: each image or plasma-mapped depth where matplotlib's imshow
    puts it (its subplot and colorbar geometry, aspect kept, anchored as
    matplotlib anchors it); the
    keypoints as discs of scatter's size (s = 4 pt^2 plus the 1.5 pt edge)
    in matplotlib's hsv colours; the colorbars as 256 bands with a black
    outline. The images are resampled as imshow's default does (nearest
    where an image grows 3 times or more, else a hanning filter), in
    float64. Not drawn: the titles, the colorbars' ticks and tick labels,
    and Agg's antialiased edges and its fixed-point filter weights, so these
    files match matplotlib's on the panel pixels within a tolerance, not bit
    for bit.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.png import encode_png
from gd3d_torch.data.resample import resize_linear_cv, resize_linear_f32

# cv2.applyColorMap(., COLORMAP_JET) of OpenCV 5.0.0: 256 BGR entries
_JET_BGR = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080"), np.uint8).reshape(256, 3)

# matplotlib 3.10's plasma colormap as bytes (cmap(i, bytes=True)): 256 RGB entries
_PLASMA = np.frombuffer(bytes.fromhex(
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f230590250591270592"
    "2905932b05942d04942f04953104963304973404983604983804993a049a3b039a3d039b"
    "3f039c40039c42039d44039e45039e47029f49029f4a02a04c02a14e02a14f02a25101a2"
    "5201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
    "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a8"
    "7801a87901a87b02a87c02a77e03a77f03a78104a78204a78405a68506a68607a68807a5"
    "8908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f"
    "9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8b"
    "b7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80"
    "c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678cb4777cc4876cd4975ce4a75"
    "cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
    "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660"
    "e3675fe3685ee46a5de56b5ce56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455"
    "eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4ef0804df0814df1824cf2844b"
    "f2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436"
    "fca635fca735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62d"
    "fdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328fdc427fdc626fcc726fcc926"
    "fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
    "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126"
    "f1f326f0f525f0f623eff821"), np.uint8).reshape(256, 3)

# matplotlib 3.10's hsv colormap as bytes: 256 RGB entries
_HSV = np.frombuffer(bytes.fromhex(
    "ff0000ff0500ff0b00ff1100ff1700ff1d00ff2300ff2900ff2f00ff3500ff3b00ff4000"
    "ff4600ff4c00ff5200ff5800ff5e00ff6400ff6a00ff7000ff7600ff7c00ff8100ff8700"
    "ff8d00ff9300ff9900ff9f00ffa500ffab00ffb100ffb700ffbd00ffc200ffc800ffce00"
    "ffd400ffda00ffe000ffe600ffec00fdf100fbf500faf900f8fc00f4ff00eeff00e8ff00"
    "e2ff00dcff00d6ff00d0ff00caff00c4ff00bfff00b9ff00b3ff00adff00a7ff00a1ff00"
    "9bff0095ff008fff0089ff0083ff007eff0078ff0072ff006cff0066ff0060ff005aff00"
    "54ff004eff0048ff0043ff003dff0037ff0031ff002bff0025ff001fff0019ff0013ff00"
    "0dff0007ff0005ff0304ff0702ff0b00ff0f00ff1500ff1b00ff2100ff2700ff2d00ff33"
    "00ff3900ff3e00ff4400ff4a00ff5000ff5600ff5c00ff6200ff6800ff6e00ff7400ff79"
    "00ff7f00ff8500ff8b00ff9100ff9700ff9d00ffa300ffa900ffaf00ffb500ffba00ffc0"
    "00ffc600ffcc00ffd200ffd800ffde00ffe400ffea00fff000fff500fffb00fcff00f6ff"
    "00f0ff00eaff00e4ff00deff00d8ff00d2ff00ccff00c7ff00c1ff00bbff00b5ff00afff"
    "00a9ff00a3ff009dff0097ff0091ff008bff0086ff0080ff007aff0074ff006eff0068ff"
    "0062ff005cff0056ff0050ff004bff0045ff003fff0039ff0033ff002dff0027ff0021ff"
    "001bff0015ff000fff010cff0308ff0504ff0700ff0d00ff1300ff1900ff1f00ff2500ff"
    "2b00ff3100ff3600ff3c00ff4200ff4800ff4e00ff5400ff5a00ff6000ff6600ff6c00ff"
    "7100ff7700ff7d00ff8300ff8900ff8f00ff9500ff9b00ffa100ffa700ffad00ffb200ff"
    "b800ffbe00ffc400ffca00ffd000ffd600ffdc00ffe200ffe800ffee00fff300fff700fd"
    "f900f9fb00f5fd00f1ff00ecff00e6ff00e0ff00daff00d4ff00cfff00c9ff00c3ff00bd"
    "ff00b7ff00b1ff00abff00a5ff009fff0099ff0093ff008eff0088ff0082ff007cff0076"
    "ff0070ff006aff0064ff005eff0058ff0052ff004dff0047ff0041ff003bff0035ff002f"
    "ff0029ff0023ff001dff0017"), np.uint8).reshape(256, 3)

# cv2.circle(img, c, 3, color, -1) (LINE_8): the (dy, dx) offsets it fills
_DISC_3 = np.array([(-3, 0), (-2, -2), (-2, -1), (-2, 0), (-2, 1), (-2, 2), (-1, -2), (-1, -1),
                    (-1, 0), (-1, 1), (-1, 2), (0, -3), (0, -2), (0, -1), (0, 0), (0, 1), (0, 2),
                    (0, 3), (1, -2), (1, -1), (1, 0), (1, 1), (1, 2), (2, -2), (2, -1), (2, 0),
                    (2, 1), (2, 2), (3, 0)])
# matplotlib's figures: 15 x 5 inches at 100 dpi
_FIG_W, _FIG_H, _DPI = 1500, 500, 100.0


def _ensure_dir(d: str) -> None:
    os.makedirs(d, exist_ok=True)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo + 1e-8)
    return (img * 255).astype(np.uint8)


def _upsample(msk: np.ndarray, size) -> np.ndarray:
    """cv2.resize(msk, size) (INTER_LINEAR) of a float32 or float64 map."""
    if msk.dtype == np.float64:
        return resize_linear_cv(msk, size)
    return resize_linear_f32(np.asarray(msk, np.float32), size)


def vis_attn_map(
    attn_map: np.ndarray,
    img_target: np.ndarray,
    img_source: np.ndarray,
    count: int,
    p_size: int = 16,
    save_path: str = "visualization/camap",
    num_vis: int = 8,
    seed: int = 0,
) -> str:
    """Cross-attention heatmap overlays: pick random source patches,
    upsample their attention rows over the target image, JET-colormap
    overlay. attn_map (hw, hw), images NHWC."""
    _ensure_dir(save_path)
    H, W = img_target.shape[:2]
    pH, pW = H // p_size, W // p_size
    rng = np.random.RandomState(seed)
    src8 = _to_uint8(img_source)
    tgt8 = _to_uint8(img_target)

    rows = []
    for _ in range(num_vis):
        idx_h = rng.randint(pH)
        idx_w = rng.randint(pW)
        idx_n = idx_h * pW + idx_w
        marked = src8.copy()
        marked[idx_h * p_size : (idx_h + 1) * p_size,
               idx_w * p_size : (idx_w + 1) * p_size] = 255
        msk = _upsample(np.asarray(attn_map[idx_n]).reshape(pH, pW), (W, H))
        heat = _JET_BGR[_to_uint8(msk)]
        overlay = _to_uint8(tgt8[..., ::-1].astype(np.int32) + heat)
        rows.append(np.concatenate([marked[:, :, ::-1], overlay], axis=1))
    out = np.concatenate(rows, axis=0)
    path = os.path.join(save_path, f"count{count}_all_points.jpg")
    save_jpeg(path, np.ascontiguousarray(out[..., ::-1]), quality=95)
    return path


def visualize_tracking_results(
    images: np.ndarray,
    trajectories_dict: Dict[int, np.ndarray],
    occlusions_dict: Dict[int, np.ndarray],
    save_dir: str,
) -> Sequence[str]:
    """Trajectory overlays per frame: a filled disc of radius 3 at each
    track's point, red where occluded, green where not."""
    _ensure_dir(save_dir)
    T = images.shape[0]
    paths = []
    for t in range(T):
        frame = _to_uint8(images[t])[:, :, ::-1].copy()
        h, w = frame.shape[:2]
        for frame_idx, trajs in trajectories_dict.items():
            occ = occlusions_dict.get(frame_idx)
            for n in range(trajs.shape[0]):
                x, y = trajs[n, t]
                occluded = bool(occ[n, t]) if occ is not None else False
                color = (0, 0, 255) if occluded else (0, 255, 0)
                ys, xs = int(y) + _DISC_3[:, 0], int(x) + _DISC_3[:, 1]
                keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
                frame[ys[keep], xs[keep]] = color
        p = os.path.join(save_dir, f"frame_{t:04d}.jpg")
        save_jpeg(p, np.ascontiguousarray(frame[..., ::-1]), quality=95)
        paths.append(p)
    return paths


def _canvas() -> np.ndarray:
    return np.full((_FIG_H, _FIG_W, 4), 255, np.uint8)


def _image_box(box, shape, anchor_x: float):
    """Where imshow puts an (h, w) image in the axes box (x0, top, width,
    height) in pixels from the top left: aspect kept, the box shrunk to the
    image and anchored at (anchor_x, 0.5). Returns (x0, top, scale)."""
    bx, by, bw, bh = box
    h, w = shape
    s = min(bw / w, bh / h)
    return bx + anchor_x * (bw - w * s), by + 0.5 * (bh - h * s), s


def _filter_weights(pixels: np.ndarray, origin: float, s: float, n_src: int) -> np.ndarray:
    """(len(pixels), n_src) weights of matplotlib's default image resampling
    along one axis: canvas pixel i (centre i + 0.5) from the source samples
    (centres origin + (j + 0.5) s) at the hanning filter's distance, the
    filter stretched by 1 / s where the image shrinks; normalized over the
    samples on the image."""
    u = (pixels + 0.5 - origin) / s - 0.5
    radius = max(1.0, 1.0 / s)
    t = np.abs(u[:, None] - np.arange(n_src)[None, :]) / radius
    w = np.where(t < 1.0, 0.5 + 0.5 * np.cos(np.pi * np.minimum(t, 1.0)), 0.0)
    return w / np.maximum(w.sum(1, keepdims=True), 1e-12)


def _paint_image(canvas, rgb: np.ndarray, x0: float, top: float, s: float) -> None:
    """rgb (h, w, 3) uint8 drawn in its box as imshow's default resampling
    draws it: nearest where the image grows 3 times or more, else the
    hanning filter (matplotlib's "antialiased"), at the pixel centres."""
    h, w = rgb.shape[:2]
    cols = np.arange(max(int(np.floor(x0)), 0), min(int(np.ceil(x0 + w * s)), canvas.shape[1]))
    rows = np.arange(max(int(np.floor(top)), 0), min(int(np.ceil(top + h * s)), canvas.shape[0]))
    cols = cols[(cols + 0.5 >= x0) & (cols + 0.5 < x0 + w * s)]
    rows = rows[(rows + 0.5 >= top) & (rows + 0.5 < top + h * s)]
    if s >= 3.0:
        sc = np.minimum(np.floor((cols + 0.5 - x0) / s).astype(np.int64), w - 1)
        sr = np.minimum(np.floor((rows + 0.5 - top) / s).astype(np.int64), h - 1)
        canvas[rows[:, None], cols[None, :], :3] = rgb[sr[:, None], sc[None, :]]
        return
    wx, wy = _filter_weights(cols, x0, s, w), _filter_weights(rows, top, s, h)
    rows_f = (wy @ rgb.astype(np.float64).reshape(h, w * 3)).reshape(-1, w, 3)
    out = np.einsum("qw,rwc->rqc", wx, rows_f, optimize=True)
    canvas[rows[:, None], cols[None, :], :3] = np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _rgb8(image: np.ndarray) -> np.ndarray:
    """An (h, w, 3) image as imshow shows it: uint8 as it is, floats clipped
    to [0, 1]."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"takes (h, w, 3) images, got {image.shape}")
    if image.dtype == np.uint8:
        return image
    return (np.clip(image.astype(np.float64), 0.0, 1.0) * 255).astype(np.uint8)


def _lut(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """matplotlib's Colormap.__call__ of values in [0, 1] over a 256-entry
    table: index int(v * 256), 1.0 on the last entry."""
    idx = np.clip((np.asarray(values, np.float64) * 256).astype(np.int64), 0, 255)
    return table[idx]


def visualize_matching_pairs(
    image1: np.ndarray,
    image2: np.ndarray,
    kp1: np.ndarray,
    kp2: np.ndarray,
    epoch: int,
    batch_idx: int,
    output_dir: str = "visualization/debug_match",
    valid: Optional[np.ndarray] = None,
) -> str:
    """Side-by-side keypoint scatter: each image in its half of the figure
    (aspect kept, centred), the i-th pair of keypoints in the i-th of n hsv
    colours. Keypoints must lie on their image (matplotlib would widen the
    axes to hold others)."""
    _ensure_dir(output_dir)
    kp1 = np.asarray(kp1).reshape(-1, 2)
    kp2 = np.asarray(kp2).reshape(-1, 2)
    if valid is not None:
        kp1 = kp1[np.asarray(valid).reshape(-1)]
        kp2 = kp2[np.asarray(valid).reshape(-1)]
    n = min(len(kp1), len(kp2))
    kp1, kp2 = kp1[:n], kp2[:n]
    colors = _lut(np.linspace(0, 1, max(n, 1)), _HSV)[:n]
    canvas = _canvas()
    radius = (np.sqrt(4.0) + 1.5) / 2 * _DPI / 72.0  # marker and edge, in pixels
    for i, (image, kp) in enumerate(((image1, kp1), (image2, kp2))):
        rgb = _rgb8(image)
        h, w = rgb.shape[:2]
        kp = kp.astype(np.float64)
        if len(kp) and ((kp < -0.5).any() or (kp[:, 0] > w - 0.5).any()
                        or (kp[:, 1] > h - 0.5).any()):
            raise ValueError("visualize_matching_pairs: keypoints off the image are not drawn "
                             "as matplotlib draws them (it widens the axes)")
        x0, top, s = _image_box((_FIG_W / 2 * i, 0.0, _FIG_W / 2, _FIG_H), (h, w), 0.5)
        _paint_image(canvas, rgb, x0, top, s)
        yy, xx = np.mgrid[0:_FIG_H, 0:_FIG_W]
        for (kx, ky), c in zip(kp, colors):
            cx, cy = x0 + (kx + 0.5) * s, top + (ky + 0.5) * s
            r0, r1 = int(max(cy - radius - 1, 0)), int(min(cy + radius + 2, _FIG_H))
            c0, c1 = int(max(cx - radius - 1, 0)), int(min(cx + radius + 2, _FIG_W))
            disc = ((xx[r0:r1, c0:c1] + 0.5 - cx) ** 2 + (yy[r0:r1, c0:c1] + 0.5 - cy) ** 2
                    <= radius ** 2)
            canvas[r0:r1, c0:c1, :3][disc] = c
    path = os.path.join(output_dir, f"match_epoch{epoch}_batch{batch_idx}.png")
    with open(path, "wb") as f:
        f.write(encode_png(canvas))
    return path


def visualize_depth_maps(
    depth_pred_1: np.ndarray,
    depth_pred_2: np.ndarray,
    epoch: int,
    batch_idx: int,
    output_dir: str = "visualization/debug_depth",
) -> str:
    """Plasma depth panels with colorbars, where matplotlib's default
    subplot grid (left 0.125, right 0.9, bottom 0.11, top 0.88, wspace 0.2)
    and fig.colorbar(fraction=0.046, pad=0.04, aspect 20) put them; each
    depth normalized over its own range. Titles and ticks are not drawn."""
    _ensure_dir(output_dir)
    canvas = _canvas()
    ax_w = _FIG_W * (0.9 - 0.125) / (2 + 0.2)
    ax_h = _FIG_H * (0.88 - 0.11)
    top = _FIG_H * (1 - 0.88)
    for i, d in enumerate((depth_pred_1, depth_pred_2)):
        d = np.asarray(d, np.float64)
        if d.ndim != 2:
            raise ValueError(f"visualize_depth_maps takes (h, w) depths, got {d.shape}")
        ax_x = _FIG_W * 0.125 + i * ax_w * 1.2
        lo, hi = np.nanmin(d), np.nanmax(d)
        v = np.zeros_like(d) if hi == lo else (d - lo) / (hi - lo)
        rgb = _lut(np.nan_to_num(v), _PLASMA)
        rgb[np.isnan(d)] = 255  # a masked value shows the background
        x0, y0, s = _image_box((ax_x, top, ax_w * (1 - 0.046 - 0.04), ax_h), d.shape, 1.0)
        _paint_image(canvas, rgb, x0, y0, s)
        # the colorbar: its slot's width, or the height over 20, whichever is less
        cb_w = min(ax_w * 0.046, ax_h / 20)
        cb_h = cb_w * 20
        cb_x, cb_top = ax_x + ax_w * (1 - 0.046), top + (ax_h - cb_h) / 2
        rows = np.arange(int(np.floor(cb_top)), int(np.ceil(cb_top + cb_h)))
        cols = np.arange(int(np.floor(cb_x)), int(np.ceil(cb_x + cb_w)))
        # 256 bands, the lowest value at the bottom, and a black outline
        band = np.clip(np.floor((cb_top + cb_h - (rows + 0.5)) / cb_h * 256), 0, 255)
        canvas[rows[:, None], cols[None, :], :3] = _PLASMA[band.astype(np.int64)][:, None]
        canvas[[rows[0], rows[-1]], cols[0]:cols[-1] + 1, :3] = 0
        canvas[rows[0]:rows[-1] + 1, [cols[0], cols[-1]], :3] = 0
    path = os.path.join(output_dir, f"depth_epoch{epoch}_batch{batch_idx}.png")
    with open(path, "wb") as f:
        f.write(encode_png(canvas))
    return path
