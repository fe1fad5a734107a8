"""K1: flash-attention forward with the row log-sum-exp.

Wrapper of the CUDA kernels in gd3d_torch/csrc/flash_fwd_sm90.cu (bf16 at
every kernel width, 64, 128 and 256: TMA, wgmma and warp specialisation),
flash_fwd.cu (fp32: the register-tiled CUDA-core kernel at 64, split
TF32 on mma.sync at 128 and 256), flash_fwd_cluster_sm90.cu and
flash_fwd_cluster_tf32.cu (bf16 and fp32 above 256 up to
CLUSTER_MAX_D[dtype]: thread-block clusters that split the head dim) and
flash_chunked.cu (both dtypes past it: column chunks on the CUDA cores),
which replace the stock TPU Pallas flash forward that gd3d reaches through
gd3d/ops/attention.py::_flash_call. `fwd_route` names the kernel a head dim
runs on, as the library's gd3d_flash_fwd_route, on which gd3d_flash_fwd
dispatches, does.
`flash_attention_fwd_plain` is its plain PyTorch twin: the CPU path, and the
oracle the kernel is checked against.

gd3d's flash takes any head dim, and so do the kernels. One static rule,
chosen from (D, dtype) alone and shared with K2 (`runs_direct`), routes a
head dim D: where a row of D elements is a multiple of 16 bytes (bf16 D a
multiple of 8, fp32 a multiple of 4), the kernels read the caller's D
columns at the width `kernel_width(D)` (64, 128 or 256; above 256 at D
itself, in 64-column panels), their loads filling the columns past
D with zeros (TMA, cp.async, 16-byte loads), and write D columns of O back:
no copy, no slice (the direct route). Any other D takes the pad route
(`fwd_padded`): q, k and v zero-padded along D to the width, O cut back to
D columns. Both are exact: zero columns leave Q K^T and the LSE unchanged.
A view the kernels cannot
read as it is (its last dim strided, or, for the 16-byte copies every
kernel makes (TMA, cp.async), its address or a (B, N, H) step off 16 bytes)
is copied to a fresh contiguous tensor first (`fit_views`). A failed build
or a refused launch raises; nothing falls back to the other route, another
kernel or the plain twin.
"""
from __future__ import annotations

from collections import Counter
from functools import partial

import torch
import torch.nn.functional as F

from gd3d_torch.kernels import build

HEAD_DIMS = (64, 128, 256)  # the kernel widths of K1 and K2
DTYPES = (torch.float32, torch.bfloat16)
# K1's kernels, as csrc/flash_fwd.cu::gd3d_flash_fwd_route numbers them
FWD_ROUTES = ("f32", "tf32", "sm90", "cluster", "chunked")
# K1's cluster kernels take 256 < D <= CLUSTER_MAX_D[dtype]
# (csrc/flash_fwd_cluster.cuh: fp32 kMaxD, eight CTAs of four 64-column
# panels; bf16 kMaxDBf16, three, as its inbox holds two peers' parts)
CLUSTER_MAX_D = {torch.float32: 2048, torch.bfloat16: 768}


def flash_attention_fwd_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) -> O (B, N, H, D) in q's dtype and LSE
    (B, H, N) fp32, computed in fp32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float())
    return o.to(q.dtype), lse


def aligned_16(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte copies (TMA, cp.async) can read the
    (B, N, H, D) view `t`: its first element and every step along B, N and H
    (of a dim longer than 1) fall on 16 bytes."""
    elt = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (s * elt) % 16 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def fit_views(*ts: torch.Tensor):
    """Each (B, N, H, D) view as the 16-byte copies of the kernels (TMA,
    cp.async) read it: itself where its last dim is contiguous, it is
    `aligned_16` and no dim longer than 1 has a step of 0 (an expanded
    gradient), else a fresh contiguous copy."""
    def fits(t):
        return (t.stride(-1) == 1 and aligned_16(t)
                and all(n == 1 or s != 0 for n, s in zip(t.shape[:3], t.stride()[:3])))

    return tuple(t if fits(t) else t.clone(memory_format=torch.contiguous_format) for t in ts)


def kernel_width(D: int, widths=HEAD_DIMS) -> int:
    """The kernel width that head dim D runs at: the least of `widths` that
    holds it, or above the widest (the chunked kernels, which take any row
    of 16 bytes), the next multiple of 8: a 16-byte row in either dtype."""
    for w in widths:
        if D <= w:
            return w
    return -(-D // 8) * 8


def runs_chunked(D: int) -> bool:
    """Whether head dim D runs K2 on the chunked kernels (flash_chunked.cu):
    above the widest kernel width. K1 runs there only past
    CLUSTER_MAX_D[dtype] (`fwd_route`); its launches above 256 count as
    "K1 wide" all the same."""
    return D > HEAD_DIMS[-1]


def fwd_route(D: int, dtype: torch.dtype) -> str:
    """The K1 kernel that the caller's head dim D runs on, as
    gd3d_flash_fwd_route (csrc/flash_fwd.cu), which gd3d_flash_fwd
    dispatches on, names it for the head dim the wrapper launches at (D, or
    kernel_width(D) on the pad route): "sm90" (bf16 up to 256,
    flash_fwd_sm90.cu), "f32" (fp32 up to 64) or "tf32" (fp32 at 128 and
    256, flash_fwd.cu), "cluster" (256 < D <= CLUSTER_MAX_D[dtype],
    flash_fwd_cluster_sm90.cu for bf16, flash_fwd_cluster_tf32.cu for fp32)
    or "chunked" (past it, flash_chunked.cu)."""
    width = D if runs_direct(D, dtype) else kernel_width(D)
    if width > CLUSTER_MAX_D[dtype]:
        return "chunked"
    if width > HEAD_DIMS[-1]:
        return "cluster"
    if dtype == torch.bfloat16:
        return "sm90"
    return "f32" if width <= HEAD_DIMS[0] else "tf32"


def runs_direct(D: int, dtype: torch.dtype) -> bool:
    """The static routing rule of K1 and K2: head dim D runs direct (the
    kernels read and write D columns at `kernel_width(D)`) where a row of D
    elements of `dtype` is a multiple of 16 bytes; any other D takes the pad
    route."""
    return D > 0 and D * (torch.finfo(dtype).bits // 8) % 16 == 0


def pad_head_dim(width: int, *ts: torch.Tensor):
    """Each tensor zero-padded along its last dim to `width` (itself where it
    is that wide already)."""
    return tuple(t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1])) for t in ts)


def check_views(*ts: torch.Tensor, fp32_copies_16: bool = False) -> None:
    """The layout the flash kernels take, on any device: tensors of one dtype
    (fp32 or bf16), (B, N, H, D) with a contiguous last dim and D a head dim
    they read direct (`runs_direct`: a row of D a multiple of 16 bytes).
    bf16 views must be `aligned_16`, and with `fp32_copies_16` (K1 and K2,
    whose fp32 kernels copy 16 bytes at a time at every width) fp32 views
    too. It raises where a view does not fit (the wrappers pass it views
    that `fit_views` and `fwd_padded` made fit)."""
    t0 = ts[0]
    for t in ts:
        if t.dtype != t0.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash kernels take one dtype of {DTYPES}, got "
                             f"{[x.dtype for x in ts]}")
        if (t.dim() != 4 or not runs_direct(t.shape[-1], t.dtype)
                or t.shape[-1] != t0.shape[-1] or t.stride(-1) != 1):
            raise ValueError(f"flash kernels take (B, N, H, D) views with a row of D a "
                             f"multiple of 16 bytes and a contiguous last dim, got "
                             f"{t.dtype} shape {tuple(t.shape)} strides {t.stride()}")
        if (t.dtype == torch.bfloat16 or fp32_copies_16) and not aligned_16(t):
            raise ValueError(f"this flash kernel copies 16-byte chunks: the "
                             f"{t.dtype} view's address and its (B, N, H) steps must "
                             f"fall on 16 bytes, got offset {t.data_ptr() % 16} strides "
                             f"{t.stride()}")


def check_operands(*ts: torch.Tensor, **layout) -> None:
    """What the flash kernels take: CUDA tensors on one device, in the layout
    of `check_views`."""
    for t in ts:
        if not t.is_cuda or t.device != ts[0].device:
            raise ValueError(f"flash kernels need CUDA tensors on one device, "
                             f"got {t.device}")
    check_views(*ts, **layout)


def fwd_padded(run, q, k, v, scale: float):
    """K1's pad route at any head dim D: `run` (the kernel's launch, or a
    plain twin) on q, k, v zero-padded along D to the kernel width, with the
    caller's scale; O cut back to D columns."""
    D = q.shape[-1]
    width = kernel_width(D)
    if width == D:
        return run(q, k, v, scale)
    o, lse = run(*pad_head_dim(width, q, k, v), scale)
    return o[..., :D], lse


def fwd_routed(run, q, k, v, scale: float):
    """K1 by the routing rule: `run` on q, k, v as they are where their head
    dim runs direct, else through `fwd_padded`."""
    if runs_direct(q.shape[-1], q.dtype):
        return run(q, k, v, scale)
    return fwd_padded(run, q, k, v, scale)


def _launch(q, k, v, scale: float, padded: bool = False):
    q, k, v = fit_views(q, k, v)
    check_operands(q, k, v, fp32_copies_16=True)
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {q.shape} k {k.shape} v {v.shape}")
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library()
    err = lib.gd3d_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, M, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_padded += padded
    dname = str(q.dtype).removeprefix("torch.")
    if runs_chunked(D):  # counted by the kernel the library's dispatch ran
        route = lib.gd3d_flash_fwd_route(D, int(q.dtype == torch.bfloat16))
        flash_attention_fwd.launches_wide += 1
        flash_attention_fwd.launches_wide_by[(FWD_ROUTES[route], dname)] += 1
    flash_attention_fwd.launches_by[(dname, N)] += 1
    return o, lse


def flash_attention_fwd(q, k, v, scale: float):
    """K1. CPU tensors run the plain twin; CUDA tensors launch the kernel,
    direct or on the pad route by `runs_direct`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    if runs_direct(q.shape[-1], q.dtype):
        return _launch(q, k, v, scale)
    return fwd_padded(partial(_launch, padded=True), q, k, v, scale)


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_padded = 0  # of them, launches on the pad route
flash_attention_fwd.launches_wide = 0  # of them, above head dim 256
# of those, by kernel and dtype: (FWD_ROUTES[gd3d_flash_fwd_route], dtype) -> launches
flash_attention_fwd.launches_wide_by = Counter()
flash_attention_fwd.launches_by = Counter()  # (dtype, N) -> launches
