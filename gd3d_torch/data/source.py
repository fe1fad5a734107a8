"""The input every decoder of gd3d_torch/data takes: a path, or the file's
bytes with the name its errors should give."""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

Source = Union[str, os.PathLike, bytes]


def read_source(src: Source, name: Optional[str] = None) -> Tuple[bytes, str]:
    """(the file's bytes, the name errors give): the path itself for a path,
    `name` (or "<bytes>") for bytes."""
    if isinstance(src, (bytes, bytearray)):
        return bytes(src), name or "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)
