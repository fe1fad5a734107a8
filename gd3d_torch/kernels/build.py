"""Build and load the hand-written CUDA kernels.

nvcc compiles every `gd3d_torch/csrc/*.cu` for sm_90a, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which ctypes loads. The library goes to
`gd3d_torch/build/` (listed in .gitignore) under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing is built when the package is imported: the first kernel
launch (or an explicit `build()`) does it.

Every C entry point returns cudaGetLastError() after its launches; the
wrappers raise on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "gd3d_flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _P],
    "gd3d_flash_bwd": [_P] * 9 + [_I] * 5 + [_L] * 12 + [_F, _I, _P],
    "gd3d_cost_kl": [_P] * 4 + [_I] * 3 + [_F, _P],
    "gd3d_rope2d": [_P] * 3 + [_I] * 4 + [_L] * 9 + [_F, _F, _I, _P],
    "gd3d_pairwise_rank_fwd": [_P] * 11 + [_I] * 4 + [_F, _F, _P],
    "gd3d_pairwise_rank_bwd": [_P] * 12 + [_I] * 4 + [_F, _F, _P],
    "gd3d_pairwise_rank_scratch": [_I] * 5,
}
_RESTYPES = {"gd3d_pairwise_rank_scratch": ctypes.c_longlong}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libgd3d_kernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if it is not built yet. Returns nvcc's report
    (ptxas registers, shared memory and spills per kernel), or "" when an
    up-to-date library was already there."""
    so = library_path()
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    report, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_name(f"{tag}.so.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return "".join(report) + res.stdout + res.stderr


@functools.cache
def library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
