"""EXIF orientation, read from a JPEG's APP1 segment or a PNG's eXIf
chunk, and applied as PIL's `ImageOps.exif_transpose` applies it.

gd3d's image loaders open files with `ImageOps.exif_transpose(Image.open(f))`
(gd3d/data/images.py::_to_pil). Orientation 1, a missing tag, a missing
EXIF block or a value outside 1-8 leave the image as it is; 2-8 flip and
rotate it as Pillow's Transpose methods do.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ORIENTATION_TAG = 0x0112


def orientation(tiff: Optional[bytes]) -> int:
    """The Orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF block
    (without the "Exif\\0\\0" prefix), or 1 where there is none."""
    if not tiff or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", tiff[4:8])
        (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, kind, count = struct.unpack(e + "HHI", tiff[at:at + 8])
            if tag == ORIENTATION_TAG and kind == 3 and count >= 1:
                return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
    except struct.error:  # a truncated block: no tag read
        return 1
    return 1


def jpeg_exif(data: bytes) -> Optional[bytes]:
    """The first APP1 "Exif\\0\\0" segment's TIFF block of a JPEG, before
    its first scan, or None."""
    from gd3d_torch.data.jpeg import _segments

    for marker, payload, _ in _segments(data, "<bytes>"):
        if marker == 0xDA:
            return None
        if marker == 0xE1 and payload[:6] == b"Exif\x00\x00":
            return payload[6:]
    return None


def transpose(img: np.ndarray, value: int) -> np.ndarray:
    """img (H, W, ...) as PIL's exif_transpose leaves it for the
    orientation `value`: 2 FLIP_LEFT_RIGHT, 3 ROTATE_180, 4 FLIP_TOP_BOTTOM,
    5 TRANSPOSE, 6 ROTATE_270, 7 TRANSVERSE, 8 ROTATE_90 (counter-clockwise
    angles); a copy either way."""
    swap = img.swapaxes(0, 1)
    out = {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: swap,
           6: swap[:, ::-1], 7: swap[::-1, ::-1], 8: swap[::-1]}.get(value, img)
    return np.ascontiguousarray(out) if out is not img else img.copy()
