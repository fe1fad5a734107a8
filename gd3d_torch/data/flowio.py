"""Stereo-disparity and optical-flow files, visualization and augmentation
(counterpart of gd3d/data/flowio.py; datasets_stereo.py:541-661,
datasets_flow.py:378-618, augmentor.py), without cv2, PIL or h5py.

Every loader returns float32 (H, W, C) arrays with +inf at invalid pixels,
the convention the losses and metrics of gd3d_torch/stereoflow.py mask on.
What gd3d does through a library, the port does itself, to the same arrays:

  - `read_img`: PIL's Image.open(f).convert("RGB") of a PNG or JPEG
    (data/png.py, data/jpeg.py; no EXIF transpose and no alpha composite,
    as that call has neither);
  - KITTI disparities (PIL's uint16 array of a grey PNG) and flows
    (cv2.imread(f, IMREAD_ANYDEPTH | IMREAD_COLOR)) through data/png.py;
    `write_kitti_disp` / `write_kitti_flow` write 16-bit grey and RGB PNGs
    with data/png.py::encode_png, which read back to the arrays cv2 and PIL
    read from gd3d's files (the bytes differ);
  - `vis_disparity`: cv2.applyColorMap(., COLORMAP_INFERNO) as a 256 x 3 BGR
    table of OpenCV 5.0.0's colours (`_INFERNO`);
  - `adjust_hue`: COLOR_RGB2HSV / COLOR_HSV2RGB through data/augment.py's
    OpenCV-exact conversions;
  - the augmentors' cv2.resize(img, None, fx, fy) as `resize_cv`, which is
    data/resample.py's (the port's one module of cv2 resizes): INTER_LINEAR
    on uint8 images in OpenCV's 11-bit fixed point, on 2-channel float32
    images (dense flow) in float32 multiplies and adds, on 1-, 3- and
    4-channel float32 images (disparities) with OpenCV 5's fused
    multiply-adds, the halving by INTER_AREA where OpenCV takes it, and
    INTER_NEAREST at floor(x / f); getRotationMatrix2D and warpAffine from
    data/augment.py.

The colour wheel, flow_to_color, the PFM and .flo codecs and the other
adjust_* functions are gd3d's numpy. The augmentors draw from their
RandomState in gd3d's order and number. The HDF5 readers and write_flo5
go through data/hdf5.py, h5py's arrays without h5py.
"""
from __future__ import annotations

import os
import re
import struct
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gd3d_torch.data import augment, hdf5, png
from gd3d_torch.data.images import decode_rgb, read_bytes
from gd3d_torch.data.resample import resize_cv

# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

IN1K_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IN1K_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_img(path: str) -> np.ndarray:
    """datasets_stereo.py:541-544: (H, W, 3) uint8 RGB, PIL's
    Image.open(path).convert("RGB") of a PNG or JPEG."""
    data = read_bytes(path)
    if data[:8] == png.SIGNATURE:
        return png.pil_rgb(png.decode_png(data), composite=False)
    return decode_rgb(data, os.fspath(path))


def img_to_array(img_u8: np.ndarray) -> np.ndarray:
    """datasets_stereo.py:44-46 in NHWC: /255, ImageNet-normalize."""
    return ((img_u8.astype(np.float32) / 255.0) - IN1K_MEAN) / IN1K_STD


# ---------------------------------------------------------------------------
# PFM (datasets_stereo.py:580-640)
# ---------------------------------------------------------------------------


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not dim:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype != np.float32:
        raise ValueError("Image dtype must be float32.")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


# ---------------------------------------------------------------------------
# disparity codecs (datasets_stereo.py:546-578)
# ---------------------------------------------------------------------------


def read_png_disp(path: str, coef: float = 1.0) -> np.ndarray:
    """PIL's array of the PNG (png.pil_array, any mode) / coef, 0 -> +inf."""
    disp = png.pil_array(png.decode_png(path)).astype(np.float32) / coef
    disp[disp == 0.0] = np.inf
    return disp


def read_kitti_disp(path: str) -> np.ndarray:
    return read_png_disp(path, coef=256.0)


def write_kitti_disp(path: str, disp: np.ndarray) -> None:
    """The inverse of read_kitti_disp: uint16 at 1/256 px, 0 = invalid."""
    d = np.where(np.isfinite(disp), disp, 0.0)
    with open(path, "wb") as f:
        f.write(png.encode_png((d * 256.0).round().clip(0, 65535).astype(np.uint16)))


def read_crestereo_disp(path: str) -> np.ndarray:
    return read_png_disp(path, coef=32.0)


def read_pfm_disp(path: str) -> np.ndarray:
    """<= 0 -> +inf (datasets_stereo.py:557-560)."""
    disp = np.ascontiguousarray(read_pfm(path)[0]).astype(np.float32)
    disp[disp <= 0] = np.inf
    return disp


def read_hdf5_disp(path: str) -> np.ndarray:
    """The "disparity" dataset (data/hdf5.py), NaN -> +inf."""
    disp = hdf5.read_dataset(path, "disparity")
    disp[np.isnan(disp)] = np.inf
    return disp.astype(np.float32)


# ---------------------------------------------------------------------------
# flow codecs (datasets_flow.py:378-489)
# ---------------------------------------------------------------------------

TAG_FLOAT = 202021.25
TAG_STRING = "PIEH"


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        tag = struct.unpack("f", f.read(4))[0]
        if tag != TAG_FLOAT:
            raise ValueError(f"read_flo({path}): wrong tag")
        w, h = struct.unpack("ii", f.read(8))
        if not (0 < w < 100000 and 0 < h < 100000):
            raise ValueError(f"read_flo({path}): illegal size {w}x{h}")
        flow = np.fromfile(f, "float32")
        if flow.shape != (h * w * 2,):
            raise ValueError(f"read_flo({path}): illegal file size")
        return flow.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    if flow.shape[2:] != (2,):
        raise ValueError("flow must be (H, W, 2)")
    with open(path, "wb") as f:
        f.write(TAG_STRING.encode("utf-8"))
        f.write(struct.pack("ii", flow.shape[1], flow.shape[0]))
        flow.astype(np.float32).tofile(f)


def read_kitti_flow(path: str) -> np.ndarray:
    """datasets_flow.py:455-464: a 16-bit PNG of (u*64+2^15, v*64+2^15,
    valid), read as cv2.imread(path, IMREAD_ANYDEPTH | IMREAD_COLOR)."""
    flow = png.imread(path, png.IMREAD_COLOR_ANYDEPTH)
    flow = flow[:, :, ::-1].astype(np.float32)
    valid = flow[:, :, 2] > 0
    flow = flow[:, :, :2]
    flow = (flow - 2 ** 15) / 64.0
    flow[~valid, 0] = np.inf
    flow[~valid, 1] = np.inf
    return flow


def write_kitti_flow(path: str, uv: np.ndarray) -> None:
    """datasets_flow.py:467-471: a 16-bit RGB PNG of (u, v, 1)."""
    uv = np.where(np.isfinite(uv), uv, 0.0)
    uv = 64.0 * uv + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    with open(path, "wb") as f:
        f.write(png.encode_png(uv))


def read_pfm_flow(path: str) -> np.ndarray:
    f, _ = read_pfm(path)
    assert np.all(f[:, :, 2] == 0.0)
    return np.ascontiguousarray(f[:, :, :2]).astype(np.float32)


def read_hdf5_flow(path: str) -> np.ndarray:
    """The "flow" dataset (data/hdf5.py), NaN -> +inf."""
    flow = hdf5.read_dataset(path, "flow")
    flow[np.isnan(flow)] = np.inf
    return flow.astype(np.float32)


def write_flo5(path: str, flow: np.ndarray) -> None:
    """The "flow" dataset, chunked and deflated at level 5, as gd3d has
    h5py write it (data/hdf5.py::write_dataset)."""
    hdf5.write_dataset(path, "flow", flow)


# ---------------------------------------------------------------------------
# visualization (datasets_stereo.py:654-660, datasets_flow.py:503-618)
# ---------------------------------------------------------------------------

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_INFERNO) of
# OpenCV 5.0.0: 256 BGR triples
_INFERNO = np.frombuffer(bytes.fromhex(
    "0400000500010601010801010a01020c02020e02021002031203041403041704051904061b05071d05081f06"
    "0922070a24070b26080c29080d2b090e2d0910300a11320a12340b14370b15390b163c0c183e0c19410c1b43"
    "0c1c450c1e480c1f4a0c214c0c234f0c24510c26530b28550b29570b2b590b2d5b0a2f5c0a315e0a325f0a34"
    "61093662093863093964093b65093d66093e670a40680a42680a44690a456a0b476a0b496b0c4a6b0c4c6c0d"
    "4d6c0d4f6c0e516d0e526d0f546d0f556e10576e10596e115a6e125c6e125d6e135f6e13616e14626e15646e"
    "15656e16676e16696e176a6e186c6e186d6e196f6e19716e1a726e1a746e1b756d1c776d1c786d1d7a6d1d7c"
    "6d1e7d6c1e7f6c1f806c20826b20846b21856b21876a22886a228a69238c69238d69248f6825906825926726"
    "9367269566279766279865289a64299b64299d632a9f632aa0622ba2612ca3602ca5602da65f2ea85e2ea95e"
    "2fab5d30ad5c30ae5b31b05a32b15a32b35933b45834b65735b75635b95536ba5437bc5338bd5239bf513ac0"
    "503ac14f3bc34e3cc44d3dc64c3ec74b3fc84a40ca4941cb4842cc4743ce4644cf4545d04446d24347d34248"
    "d4414ad53f4bd73e4cd83d4dd93c4eda3b50db3a51dd3852de3753df3655e03556e13457e23359e3315ae430"
    "5ce52f5de62e5ee72d60e82b61e92a63ea2964eb2866eb2667ec2569ed246aee236cef216eef206ff01f71f1"
    "1d73f11c74f21b76f31978f31879f4177bf5157df5147ef61380f61282f71084f70f85f80e87f80c89f80b8b"
    "f90a8cf9098ef90890fa0792fa0794fa0696fb0697fb0699fb069bfb079dfb079ffc08a1fc09a3fc0aa5fc0c"
    "a6fc0da8fc0faafc11acfc12aefc14b0fc16b2fc18b4fc1ab6fb1db8fb1fbafb21bcfb23befb26c0fa28c2fa"
    "2ac4fa2dc6fa2fc7f932c9f935cbf937cdf83acff83dd1f740d3f743d5f646d7f649d9f54cdbf54fddf453df"
    "f456e1f45ae3f35de5f361e6f265e8f269eaf26decf171edf175eff179f1f17df2f282f4f286f5f38af6f38e"
    "f8f492f9f596faf69afbf89dfcf9a1fdfaa4fffc"
), np.uint8).reshape(256, 3)


def vis_disparity(disp: np.ndarray, m=None, M=None) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv2.applyColorMap(., COLORMAP_INFERNO)."""
    if m is None:
        m = disp.min()
    if M is None:
        M = disp.max()
    disp_vis = (disp - m) / max(M - m, 1e-12) * 255.0
    return _INFERNO[disp_vis.astype("uint8")]


_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
_UNKNOWN_THRESH = 1e9


def _colorwheel() -> np.ndarray:
    ncols = _RY + _YG + _GC + _CB + _BM + _MR
    cw = np.zeros((ncols, 3), "uint8")
    col = 0
    cw[:_RY, 0] = 255
    cw[:_RY, 1] = [(255 * i) // _RY for i in range(_RY)]
    col += _RY
    cw[col:col + _YG, 0] = [255 - (255 * i) // _YG for i in range(_YG)]
    cw[col:col + _YG, 1] = 255
    col += _YG
    cw[col:col + _GC, 1] = 255
    cw[col:col + _GC, 2] = [(255 * i) // _GC for i in range(_GC)]
    col += _GC
    cw[col:col + _CB, 1] = [255 - (255 * i) // _CB for i in range(_CB)]
    cw[col:col + _CB, 2] = 255
    col += _CB
    cw[col:col + _BM, 0] = [(255 * i) // _BM for i in range(_BM)]
    cw[col:col + _BM, 2] = 255
    col += _BM
    cw[col:col + _MR, 0] = 255
    cw[col:col + _MR, 2] = [255 - (255 * i) // _MR for i in range(_MR)]
    return cw


def _compute_color(flow: np.ndarray, saturate: bool = True) -> np.ndarray:
    """datasets_flow.py:550-618."""
    flow = flow.copy()
    nanidx = np.isnan(flow[:, :, 0])
    flow[nanidx] = 0.0
    cw = _colorwheel()
    ncols = cw.shape[0]
    rad = np.sqrt(np.sum(np.square(flow), 2))
    a = np.arctan2(-flow[:, :, 1], -flow[:, :, 0]) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype("int")
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    if not saturate:
        rad = np.minimum(rad, 1)
    img = np.zeros((flow.shape[0], flow.shape[1], 3), "uint8")
    for i in range(3):
        tmp = cw[:, i].astype("float")
        col0 = tmp[k0] / 255
        col1 = tmp[k1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = (255 * col * (1 - nanidx.astype("float"))).astype("uint8")
    return img


def flow_max_norm(flow: np.ndarray) -> float:
    return float(np.max(np.sqrt(np.sum(np.square(flow), 2))))


def flow_to_color(flow: np.ndarray, maxflow=None, maxmaxflow=None,
                  saturate: bool = False) -> np.ndarray:
    """datasets_flow.py:509-537: (H, W, 3) uint8 RGB."""
    flow = flow.copy()
    h, w, n = flow.shape
    assert n == 2
    unknown_idx = np.max(np.abs(flow), 2) > _UNKNOWN_THRESH
    flow[unknown_idx] = 0.0
    if maxflow is None:
        maxflow = flow_max_norm(flow)
    if maxmaxflow is not None:
        maxflow = min(maxmaxflow, maxflow)
    eps = np.spacing(1)
    img = _compute_color(flow / (maxflow + eps), saturate=saturate)
    img[np.tile(unknown_idx[:, :, np.newaxis], [1, 1, 3])] = 0.0
    return img


# ---------------------------------------------------------------------------
# colour ops (numpy ports of torchvision.transforms.functional's adjust_*)
# ---------------------------------------------------------------------------


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0, 255)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * factor, 0, 255)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).mean()
    return _blend(img.astype(np.float32), gray, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]
    return _blend(img.astype(np.float32), gray, factor)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(255.0 * gain * np.power(img.astype(np.float32) / 255.0, gamma), 0, 255)


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """Shift the hue by hue_factor (in [-0.5, 0.5] turns) through OpenCV's
    8-bit HSV (hue in [0, 180))."""
    hsv = augment.rgb2hsv(img.astype(np.uint8))
    hsv[..., 0] = (hsv[..., 0].astype(int) + int(round(hue_factor * 180))) % 180
    return augment.hsv2rgb(hsv).astype(np.float32)


# ---------------------------------------------------------------------------
# augmentors (augmentor.py): explicit RandomState
# ---------------------------------------------------------------------------


class StereoAugmentor:
    """augmentor.py:25-157: x-only random scale, random crop, v-flip,
    right-view rotate/shift jitter, (a)symmetric colour transforms."""

    def __init__(self, crop_size, scale_prob=0.5, scale_xonly=True, lhth=800.0,
                 lminscale=0.0, lmaxscale=1.0, hminscale=-0.2, hmaxscale=0.4,
                 scale_interp_nearest=True, rightjitterprob=0.5, v_flip_prob=0.5,
                 color_aug_asym=True, color_choice_prob=0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.crop_size = crop_size
        self.scale_prob = scale_prob
        self.scale_xonly = scale_xonly
        self.lhth = lhth
        self.lminscale, self.lmaxscale = lminscale, lmaxscale
        self.hminscale, self.hmaxscale = hminscale, hmaxscale
        self.scale_interp_nearest = scale_interp_nearest
        self.rightjitterprob = rightjitterprob
        self.v_flip_prob = v_flip_prob
        self.color_aug_asym = color_aug_asym
        self.color_choice_prob = color_choice_prob
        self.rng = rng if rng is not None else np.random.RandomState()

    def _random_scale(self, img1, img2, disp):
        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        near = self.scale_interp_nearest
        if self.scale_prob > 0.0 and self.rng.rand() < self.scale_prob:
            mn, mx = ((self.lminscale, self.lmaxscale) if min(h, w) < self.lhth
                      else (self.hminscale, self.hmaxscale))
            sx = float(np.clip(2.0 ** self.rng.uniform(mn, mx), (cw + 8) / float(w), None))
            sy = 1.0 if self.scale_xonly else float(np.clip(sx, (ch + 8) / float(h), None))
            img1 = resize_cv(img1, sx, sy)
            img2 = resize_cv(img2, sx, sy)
            disp = resize_cv(disp, sx, sy, nearest=near) * sx
        else:
            clip_scale = (cw + 8) / float(w)
            if clip_scale > 1.0:
                sx = clip_scale
                sy = sx if not self.scale_xonly else 1.0
                img1 = resize_cv(img1, sx, sy)
                img2 = resize_cv(img2, sx, sy)
                disp = resize_cv(disp, sx, sy, nearest=near) * sx
        return img1, img2, disp

    def _random_crop(self, img1, img2, disp):
        h, w = img1.shape[:2]
        ch, cw = self.crop_size
        assert ch <= h and cw <= w, (img1.shape, ch, cw)
        ox = self.rng.randint(w - cw + 1)
        oy = self.rng.randint(h - ch + 1)
        return (img1[oy:oy + ch, ox:ox + cw], img2[oy:oy + ch, ox:ox + cw],
                disp[oy:oy + ch, ox:ox + cw])

    def _random_vflip(self, img1, img2, disp):
        if self.v_flip_prob > 0 and self.rng.rand() < self.v_flip_prob:
            img1 = np.copy(np.flipud(img1))
            img2 = np.copy(np.flipud(img2))
            disp = np.copy(np.flipud(disp))
        return img1, img2, disp

    def _random_rotate_shift_right(self, img2):
        if self.rightjitterprob > 0.0 and self.rng.rand() < self.rightjitterprob:
            angle, pixel = 0.1, 2
            px = self.rng.uniform(-pixel, pixel)
            ag = self.rng.uniform(-angle, angle)
            center = (self.rng.uniform(0, img2.shape[0]), self.rng.uniform(0, img2.shape[1]))
            rot = augment.rotation_matrix_2d(center, ag, 1.0)
            img2 = augment.warp_affine(img2, rot, img2.shape[1::-1])
            trans = np.float32([[1, 0, 0], [0, 1, px]])
            img2 = augment.warp_affine(img2, trans, img2.shape[1::-1])
        return img2

    def _color_pair(self, op, lo, hi, img1, img2):
        v = self.rng.uniform(lo, hi)
        img1 = op(img1, v)
        if self.color_aug_asym and self.rng.rand() < 0.5:
            v = self.rng.uniform(lo, hi)
        img2 = op(img2, v)
        return img1, img2

    def _random_color(self, img1, img2):
        trfs = [
            lambda a, b: (self._color_pair(adjust_contrast, 0.8, 1.2, a, b)
                          if self.rng.rand() < 0.5 else (a, b)),
            lambda a, b: (self._color_pair(adjust_gamma, 0.7, 1.5, a, b)
                          if self.rng.rand() < 0.5 else (a, b)),
            lambda a, b: (self._color_pair(adjust_brightness, 0.5, 2.0, a, b)
                          if self.rng.rand() < 0.5 else (a, b)),
            lambda a, b: (self._color_pair(adjust_hue, -0.1, 0.1, a, b)
                          if self.rng.rand() < 0.5 else (a, b)),
            lambda a, b: (self._color_pair(adjust_saturation, 0.8, 1.2, a, b)
                          if self.rng.rand() < 0.5 else (a, b)),
        ]
        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        if self.rng.rand() < self.color_choice_prob:
            t = trfs[self.rng.randint(len(trfs))]
            img1, img2 = t(img1, img2)
        else:
            order = self.rng.permutation(len(trfs))
            for i in order:
                img1, img2 = trfs[i](img1, img2)
        return img1.astype(np.float32), img2.astype(np.float32)

    def __call__(self, img1, img2, disp, dataset_name=""):
        img1, img2, disp = self._random_scale(img1, img2, disp)
        img1, img2, disp = self._random_crop(img1, img2, disp)
        img1, img2, disp = self._random_vflip(img1, img2, disp)
        img2 = self._random_rotate_shift_right(img2)
        img1, img2 = self._random_color(img1, img2)
        return img1, img2, disp


class FlowAugmentor:
    """augmentor.py:161-290: spatial scale and stretch, h/v flips with the
    flow's signs fixed, the sparse-flow-aware resize, photometric jitter."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, spatial_aug_prob=0.8,
                 stretch_prob=0.8, max_stretch=0.2, h_flip_prob=0.5, v_flip_prob=0.1,
                 asymmetric_color_aug_prob=0.2, rng: Optional[np.random.RandomState] = None):
        self.crop_size = crop_size
        self.min_scale, self.max_scale = min_scale, max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.rng = rng if rng is not None else np.random.RandomState()

    def _jitter(self, img):
        # ColorJitter(brightness=.4, contrast=.4, saturation=.4, hue=.5/3.14)
        img = adjust_brightness(img, self.rng.uniform(0.6, 1.4))
        img = adjust_contrast(img, self.rng.uniform(0.6, 1.4))
        img = adjust_saturation(img, self.rng.uniform(0.6, 1.4))
        h = 0.5 / 3.14
        img = adjust_hue(img, self.rng.uniform(-h, h))
        return img

    def color_transform(self, img1, img2):
        if self.rng.rand() < self.asymmetric_color_aug_prob:
            img1 = self._jitter(img1).astype(np.uint8)
            img2 = self._jitter(img2).astype(np.uint8)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = self._jitter(stack).astype(np.uint8)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def _resize_flow(self, flow, scale_x, scale_y, factor=1.0):
        if np.all(np.isfinite(flow)):
            flow = resize_cv(flow, scale_x / factor, scale_y / factor)
            flow = flow * [scale_x, scale_y]
        else:  # the sparse version (augmentor.py:202-231)
            ht, wd = flow.shape[:2]
            coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)),
                              axis=-1).reshape(-1, 2).astype(np.float32)
            flow = flow.reshape(-1, 2).astype(np.float32)
            valid = np.isfinite(flow[:, 0])
            coords0 = coords[valid]
            flow0 = flow[valid]
            ht1 = int(round(ht * scale_y / factor))
            wd1 = int(round(wd * scale_x / factor))
            rescale = np.array([[scale_x, scale_y]])
            coords1 = coords0 * rescale / factor
            flow1 = flow0 * rescale
            xx = np.round(coords1[:, 0]).astype(np.int32)
            yy = np.round(coords1[:, 1]).astype(np.int32)
            v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
            flow = np.inf * np.ones([ht1, wd1, 2], dtype=np.float32)
            flow[yy[v], xx[v]] = flow1[v]
        return flow

    def spatial_transform(self, img1, img2, flow, dname=""):
        if self.rng.rand() < self.spatial_aug_prob:
            ht, wd = img1.shape[:2]
            clip_min = np.maximum((self.crop_size[0] + 8) / float(ht),
                                  (self.crop_size[1] + 8) / float(wd))
            scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
            sx = sy = scale
            if self.rng.rand() < self.stretch_prob:
                sx *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
                sy *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            sx = float(np.clip(sx, clip_min, None))
            sy = float(np.clip(sy, clip_min, None))
            img1 = resize_cv(img1, sx, sy)
            img2 = resize_cv(img2, sx, sy)
            flow = self._resize_flow(flow, sx, sy, factor=2.0 if dname == "Spring" else 1.0)
        elif dname == "Spring":
            flow = self._resize_flow(flow, 1.0, 1.0, factor=2.0)

        if self.h_flip_prob > 0.0 and self.rng.rand() < self.h_flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if self.v_flip_prob > 0.0 and self.rng.rand() < self.v_flip_prob:
            img1 = img1[::-1, :]
            img2 = img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]

        y0 = (self.rng.randint(0, img1.shape[0] - self.crop_size[0])
              if img1.shape[0] - self.crop_size[0] > 0 else 0)
        x0 = (self.rng.randint(0, img1.shape[1] - self.crop_size[1])
              if img1.shape[1] - self.crop_size[1] > 0 else 0)
        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, dname=""):
        img1, img2, flow = self.spatial_transform(img1, img2, flow, dname)
        img1, img2 = self.color_transform(img1, img2)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


# ---------------------------------------------------------------------------
# datasets: pair discovery in the reference layouts, and a generic loader
# ---------------------------------------------------------------------------

def read_gt(path: str, task: str) -> np.ndarray:
    """By extension and task: (H, W, C) float32 with +inf invalids (C = 1
    disparity, C = 2 flow)."""
    ext = os.path.splitext(path)[1].lower()
    if task == "stereo":
        if ext == ".pfm":
            d = read_pfm_disp(path)
        elif ext == ".png":
            d = read_kitti_disp(path)
        elif ext == ".npy":
            d = np.load(path).astype(np.float32)
        elif ext in (".hdf5", ".h5"):
            d = read_hdf5_disp(path)
        else:
            raise ValueError(f"unknown disparity format: {path}")
        return d[..., None] if d.ndim == 2 else d
    if ext == ".flo":
        return read_flo(path)
    if ext == ".png":
        return read_kitti_flow(path)
    if ext == ".pfm":
        return read_pfm_flow(path)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext in (".hdf5", ".h5", ".flo5"):
        return read_hdf5_flow(path)
    raise ValueError(f"unknown flow format: {path}")


def discover_pairs(root: str, layout: str, task: str,
                   split: str = "train") -> List[Tuple[str, str, Optional[str]]]:
    """(img1, img2, gt or None) triplets in the reference dataset layouts:
    'generic' (left/ right/ gt/ with matching stems), 'sceneflow'
    (frames_finalpass + disparity), 'kitti15' (stereo: image_2/3 +
    disp_occ_0; flow: image_2 _10/_11 + flow_occ), 'sintel'
    (training/{clean,final} + flow), 'eth3d', 'middlebury' (im0/im1 +
    disp0GT.pfm / disp0.pfm); gd3d's globs and order."""
    import glob as _glob

    j = os.path.join
    pairs: List[Tuple[str, str, Optional[str]]] = []
    if layout == "generic":
        for L in sorted(_glob.glob(j(root, "left", "*"))):
            stem = os.path.splitext(os.path.basename(L))[0]
            rs = _glob.glob(j(root, "right", stem + ".*"))
            gs = _glob.glob(j(root, "gt", stem + ".*"))
            if rs:
                pairs.append((L, rs[0], gs[0] if gs else None))
    elif layout == "sceneflow":
        for L in sorted(_glob.glob(j(root, "**", "left", "*.png"), recursive=True)):
            R = L.replace(os.sep + "left" + os.sep, os.sep + "right" + os.sep)
            g = (L.replace("frames_finalpass", "disparity")
                  .replace("frames_cleanpass", "disparity").replace(".png", ".pfm"))
            if os.path.isfile(R):
                pairs.append((L, R, g if os.path.isfile(g) else None))
    elif layout == "kitti15" and task == "stereo":
        sub = "training" if split == "train" else "testing"
        for L in sorted(_glob.glob(j(root, sub, "image_2", "*_10.png"))):
            R = L.replace("image_2", "image_3")
            g = L.replace("image_2", "disp_occ_0")
            if os.path.isfile(R):
                pairs.append((L, R, g if os.path.isfile(g) else None))
    elif layout == "kitti15":
        sub = "training" if split == "train" else "testing"
        for L in sorted(_glob.glob(j(root, sub, "image_2", "*_10.png"))):
            R = L.replace("_10.png", "_11.png")
            g = L.replace("image_2", "flow_occ")
            if os.path.isfile(R):
                pairs.append((L, R, g if os.path.isfile(g) else None))
    elif layout == "sintel":
        # both render passes, as the reference's SintelDataset
        for render in ("clean", "final"):
            for L in sorted(_glob.glob(j(root, split + "ing", render, "*", "frame_*.png"))):
                seq = os.path.dirname(L)
                idx = int(os.path.basename(L)[len("frame_"):-len(".png")])
                R = j(seq, f"frame_{idx + 1:04d}.png")
                g = (seq.replace(os.sep + render + os.sep, os.sep + "flow" + os.sep)
                     + os.sep + f"frame_{idx:04d}.flo")
                if os.path.isfile(R):
                    pairs.append((L, R, g if os.path.isfile(g) else None))
    elif layout == "eth3d":
        for d in sorted(_glob.glob(j(root, "two_view_*", "*"))):
            L, R = j(d, "im0.png"), j(d, "im1.png")
            g = j(d, "disp0GT.pfm")
            if os.path.isfile(L) and os.path.isfile(R):
                pairs.append((L, R, g if os.path.isfile(g) else None))
    elif layout == "middlebury":
        for d in sorted(_glob.glob(j(root, "*"))):
            L, R = j(d, "im0.png"), j(d, "im1.png")
            g = j(d, "disp0.pfm")
            if os.path.isfile(L) and os.path.isfile(R):
                pairs.append((L, R, g if os.path.isfile(g) else None))
    else:
        raise ValueError(f"unknown layout {layout!r} for task {task!r}")
    return pairs


class StereoFlowPairs:
    """A map-style dataset over (img1, img2, gt) triplets: the task's
    augmentor when crop_size is given (training), ImageNet normalization
    always. Items are dicts of float32 (H, W, C) arrays and a name."""

    def __init__(self, pairs: Sequence[Tuple[str, str, Optional[str]]], task: str,
                 crop_size: Optional[Tuple[int, int]] = None, seed: int = 0,
                 root: Optional[str] = None):
        self.pairs = list(pairs)
        self.task = task
        self.crop_size = crop_size
        self.root = root  # names become root-relative (unique across scenes)
        self.rng = np.random.RandomState(seed)
        if crop_size is None:
            self.augmentor = None
        elif task == "stereo":
            self.augmentor = StereoAugmentor(crop_size, rng=self.rng)
        else:
            self.augmentor = FlowAugmentor(crop_size, rng=self.rng)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        Lp, Rp, gp = self.pairs[idx]
        img1 = read_img(Lp)
        img2 = read_img(Rp)
        gt = read_gt(gp, self.task) if gp is not None else None
        if self.augmentor is not None:
            assert gt is not None, "training requires ground truth"
            g = gt[..., 0] if self.task == "stereo" else gt
            img1, img2, g = self.augmentor(img1, img2, g)
            gt = g[..., None] if self.task == "stereo" else g
        out = {"img1": img_to_array(np.asarray(img1, np.float32)),
               "img2": img_to_array(np.asarray(img2, np.float32))}
        if gt is not None:
            out["gt"] = np.ascontiguousarray(gt, np.float32)
        if self.root:
            # scene-qualified, as the reference's pairname_to_str: bare stems
            # collide across eth3d and middlebury scenes (every left image
            # is im0.png)
            rel = os.path.splitext(os.path.relpath(Lp, self.root))[0]
            out["name"] = rel.replace(os.sep, "_")
        else:
            out["name"] = os.path.splitext(os.path.basename(Lp))[0]
        return out
