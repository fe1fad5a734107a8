"""cv2's lens undistortion without cv2 (for ScanNet++'s preprocessor,
gd3d/data/preprocess_scannetpp.py::undistort_image).

gd3d undistorts each selected frame with cv2; this module gives the same
arrays in numpy, following OpenCV 5.0.0:

  * `undistort_points`: cv::undistortPoints' iterative inversion of the
    radial-tangential model (5 fixed-point steps, the default criteria);
  * `optimal_new_camera_matrix`: cv::getOptimalNewCameraMatrix over its
    9 x 9 grid of border points, with centerPrincipalPoint;
  * `undistort_rectify_map`: cv::initUndistortRectifyMap's CV_32FC1 maps;
    the inverse of the new camera matrix by the closed 3 x 3 formula of
    cv::invert(DECOMP_LU), each row's ray stepped by repeated addition;
  * `fisheye_new_camera_matrix` and `fisheye_undistort_rectify_map`:
    cv::fisheye::estimateNewCameraMatrixForUndistortRectify (Newton's
    undistortion of the four edge midpoints) and
    cv::fisheye::initUndistortRectifyMap, whose 3 x 3 inverse is
    cv::invert(DECOMP_SVD) (eval/pnp.py's Jacobi SVD);
  * `remap_linear`: cv::remap with INTER_LINEAR on uint8 images and float
    maps as OpenCV 5 computes it, in float32: floor and fraction of the
    map, then fma(a, p01 - p00, p00) along x on both rows and
    fma(b, v1 - v0, v0) between them, rounded to nearest even and
    saturated; BORDER_REFLECT_101 reflects a tap past the edge, and
    BORDER_CONSTANT puts the border value in its place (finite maps
    within the int32 range; cv2's handling of others is not transcribed).

The float64 map arithmetic is transcribed operation by operation, in
OpenCV's order, which the tests check against cv2 bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

BORDER_CONSTANT, BORDER_REFLECT_101 = 0, 4


def _k14(dist) -> np.ndarray:
    k = np.zeros(14)
    d = np.asarray(dist, np.float64).ravel()
    k[:len(d)] = d
    return k


def undistort_points(pts: np.ndarray, K: np.ndarray, dist, R: Optional[np.ndarray] = None,
                     P: Optional[np.ndarray] = None, iters: int = 5) -> np.ndarray:
    """cv::undistortPoints(pts, K, dist, R, P) of (N, 2) float64 points with
    its default criteria (COUNT, 5 steps), returned as (N, 2) float64."""
    K = np.asarray(K, np.float64)
    k = _k14(dist)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = _matmul3(np.asarray(P, np.float64)[:, :3], RR)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    u, v = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    done = np.zeros(len(u), bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        neg = (icdist < 0) & ~done
        x = np.where(neg, (u - cx) * ifx, x)
        y = np.where(neg, (v - cy) * ify, y)
        done |= neg
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], -1)


def _matmul3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A 3 x 3 product summed in index order, as cv::gemm's small case."""
    out = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            out[i, j] = (a[i, 0] * b[0, j] + a[i, 1] * b[1, j]) + a[i, 2] * b[2, j]
    return out


def _undistort_rectangles(K, dist, size) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """getUndistortRectangles: (x, y, w, h) of the inner and outer
    rectangles of the undistorted 9 x 9 grid over the image."""
    n = 9
    w, h = size
    gy, gx = np.mgrid[0:n, 0:n]
    pts = np.stack([gx.ravel() * (w - 1) / (n - 1), gy.ravel() * (h - 1) / (n - 1)], -1)
    p = undistort_points(pts, K, dist, None, K).reshape(n, n, 2)
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K: np.ndarray, dist, size: Sequence[int], alpha: float,
                              new_size: Optional[Sequence[int]] = None,
                              center_principal_point: bool = False) -> np.ndarray:
    """cv::getOptimalNewCameraMatrix(K, dist, size, alpha, new_size, None,
    center_principal_point)[0]; size = (width, height). Only the centred
    case is transcribed (the one gd3d calls)."""
    if not center_principal_point:
        raise NotImplementedError("optimal_new_camera_matrix: only centerPrincipalPoint=True")
    new_size = tuple(size) if not new_size or new_size[0] * new_size[1] == 0 else tuple(new_size)
    M = np.asarray(K, np.float64).copy()
    cx0, cy0 = M[0, 2], M[1, 2]
    cx, cy = (new_size[0] - 1) * 0.5, (new_size[1] - 1) * 0.5
    inner, outer = _undistort_rectangles(M, dist, size)
    s0 = max(max(max(cx / (cx0 - inner[0]), cy / (cy0 - inner[1])),
                 cx / (inner[0] + inner[2] - cx0)), cy / (inner[1] + inner[3] - cy0))
    s1 = min(min(min(cx / (cx0 - outer[0]), cy / (cy0 - outer[1])),
                 cx / (outer[0] + outer[2] - cx0)), cy / (outer[1] + outer[3] - cy0))
    s = s0 * (1 - alpha) + s1 * alpha
    M[0, 0] *= s
    M[1, 1] *= s
    M[0, 2], M[1, 2] = cx, cy
    return M


def invert_lu3(S: np.ndarray) -> np.ndarray:
    """cv::invert(S, DECOMP_LU) of a 3 x 3 float64 matrix: the closed form
    of lapack.cpp's small case (determinant, cofactors times 1 / det)."""
    d = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
         - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
         + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    if d == 0:
        raise ValueError("invert_lu3: singular matrix")
    d = 1.0 / d
    t = [(S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
         (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d, (S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d,
         (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d, (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d,
         (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
         (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d]
    return np.array(t).reshape(3, 3)


def _row_rays(iR: np.ndarray, size: Sequence[int]):
    """Each pixel's (x, y, w) = iR (j, i, 1), as the maps' loops step it:
    the row's start i * iR[:, 1] + iR[:, 2], then iR[:, 0] added once a
    column, in order."""
    w, h = int(size[0]), int(size[1])
    i = np.arange(h, dtype=np.float64)[:, None]
    out = []
    for r in range(3):
        steps = np.full((h, w), iR[r, 0])
        steps[:, 0] = i[:, 0] * iR[r, 1] + iR[r, 2]
        out.append(np.cumsum(steps, axis=1))  # np.cumsum adds in order
    return out


def undistort_rectify_map(K: np.ndarray, dist, R: Optional[np.ndarray], newK: np.ndarray,
                          size: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap(K, dist, R, newK, size, CV_32FC1): the
    (h, w) float32 source x and y of every pixel."""
    K = np.asarray(K, np.float64)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    iR = invert_lu3(_matmul3(np.asarray(newK, np.float64)[:, :3], RR))
    k = _k14(dist)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = k[:12]
    u0, v0, fx, fy = K[0, 2], K[1, 2], K[0, 0], K[1, 1]
    _x, _y, _w = _row_rays(iR, size)
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2 + s4 * r2 * r2
    u = fx * xd + u0
    v = fy * yd + v0
    return u.astype(np.float32), v.astype(np.float32)


def fisheye_undistort_points(pts: np.ndarray, K: np.ndarray, D, R: Optional[np.ndarray] = None,
                             P: Optional[np.ndarray] = None, iters: int = 10,
                             eps: float = 1e-8) -> np.ndarray:
    """cv::fisheye::undistortPoints with its default criteria (Newton, at
    most 10 steps, |step| < 1e-8): (N, 2) float64. A point whose iteration
    does not converge, or whose angle flips sign, becomes (-1e6, -1e6)."""
    K = np.asarray(K, np.float64)
    k = np.zeros(4)
    k[:len(np.ravel(D))] = np.ravel(D)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = _matmul3(np.asarray(P, np.float64)[:, :3], RR)
    out = np.empty((len(pts), 2))
    for n, (pu, pv) in enumerate(np.asarray(pts, np.float64)):
        pw = ((pu - K[0, 2]) / K[0, 0], (pv - K[1, 2]) / K[1, 1])
        theta_d = np.sqrt(pw[0] * pw[0] + pw[1] * pw[1])
        theta_d = min(max(-np.pi / 2.0, theta_d), np.pi / 2.0)
        converged, theta, scale = False, theta_d, 0.0
        if abs(theta_d) > eps:
            for _ in range(iters):
                t2 = theta * theta
                t4 = t2 * t2
                t6 = t4 * t2
                t8 = t6 * t2
                k0t2, k1t4, k2t6, k3t8 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
                fix = ((theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d)
                       / (1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8))
                theta = theta - fix
                if abs(fix) < eps:
                    converged = True
                    break
            scale = np.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta_d > 0 > theta)
        if converged and not flipped:
            x, y = pw[0] * scale, pw[1] * scale
            pr = [(RR[r, 0] * x + RR[r, 1] * y) + RR[r, 2] for r in range(3)]
            out[n] = (pr[0] / pr[2], pr[1] / pr[2])
        else:
            out[n] = (-1000000.0, -1000000.0)
    return out


def fisheye_new_camera_matrix(K: np.ndarray, D, size: Sequence[int],
                              R: Optional[np.ndarray] = None, balance: float = 0.0,
                              new_size: Optional[Sequence[int]] = None,
                              fov_scale: float = 1.0) -> np.ndarray:
    """cv::fisheye::estimateNewCameraMatrixForUndistortRectify(K, D, size,
    R, balance=balance, new_size, fov_scale); size = (width, height)."""
    K = np.asarray(K, np.float64)
    w, h = int(size[0]), int(size[1])
    balance = min(max(balance, 0.0), 1.0)
    pts = np.array([[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64)
    pts = fisheye_undistort_points(pts, K, D, R)
    cn = np.array([((pts[0, 0] + pts[1, 0]) + pts[2, 0]) + pts[3, 0],
                   ((pts[0, 1] + pts[1, 1]) + pts[2, 1]) + pts[3, 1]]) * (1.0 / 4)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    pts[:, 1] *= aspect
    minx, maxx = pts[:, 0].min(), pts[:, 0].max()
    miny, maxy = pts[:, 1].min(), pts[:, 1].max()
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin = min(f1, min(f2, min(f3, f4)))
    fmax = max(f1, max(f2, max(f3, f4)))
    f = balance * fmin + (1.0 - balance) * fmax
    f *= 1.0 / fov_scale if fov_scale > 0 else 1.0
    new_f = [f, f]
    new_c = [-cn[0] * f + w * 0.5, -cn[1] * f + h * aspect * 0.5]
    new_f[1] /= aspect
    new_c[1] /= aspect
    if new_size is not None and new_size[0] * new_size[1] != 0:
        rx, ry = new_size[0] / float(w), new_size[1] / float(h)
        new_f = [new_f[0] * rx, new_f[1] * ry]
        new_c = [new_c[0] * rx, new_c[1] * ry]
    return np.array([[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]], [0, 0, 1.0]])


def fisheye_undistort_rectify_map(K: np.ndarray, D, R: Optional[np.ndarray], P: np.ndarray,
                                  size: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """cv::fisheye::initUndistortRectifyMap(K, D, R, P, size, CV_32FC1)."""
    from gd3d_torch.eval.pnp import invert_svd

    K = np.asarray(K, np.float64)
    k = np.zeros(4)
    k[:len(np.ravel(D))] = np.ravel(D)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    iR = invert_svd(_matmul3(np.asarray(P, np.float64)[:, :3], RR)[None])[0]
    _x, _y, _w = _row_rays(iR, size)
    with np.errstate(divide="ignore", invalid="ignore"):
        x, y = _x / _w, _y / _w
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
        scale = np.where(r == 0, 1.0, theta_d / r)
        u = K[0, 0] * x * scale + K[0, 2]
        v = K[1, 1] * y * scale + K[1, 2]
    behind = _w <= 0
    u = np.where(behind, np.where(_x > 0, -np.inf, np.inf), u)
    v = np.where(behind, np.where(_y > 0, -np.inf, np.inf), v)
    return u.astype(np.float32), v.astype(np.float32)


def fma32(a, b, c) -> np.ndarray:
    """a * b + c for float32 operands with one rounding to float32: the
    product is exact in float64, the sum is carried exactly as two
    doubles and rounded to odd, then to float32."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    adjust = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(adjust, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(p)
    p = np.abs(p) % (2 * n - 2)
    return np.where(p >= n, 2 * n - 2 - p, p)


def remap_linear(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                 border: int = BORDER_REFLECT_101, value: float = 0.0) -> np.ndarray:
    """cv2.remap(src, map_x, map_y, INTER_LINEAR, borderMode=border,
    borderValue=value) of a uint8 (H, W) or (H, W, C) image with float32
    maps (see the module docstring)."""
    if src.dtype != np.uint8:
        raise ValueError(f"remap_linear takes uint8 images, got {src.dtype}")
    if border not in (BORDER_CONSTANT, BORDER_REFLECT_101):
        raise ValueError(f"remap_linear: border mode {border} is not supported")
    h, w = src.shape[:2]
    mx, my = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    a, b = mx - fx, my - fy
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)

    def taps(p, n):
        if border == BORDER_REFLECT_101:
            return _reflect101(p, n), np.ones(p.shape, bool)
        return np.clip(p, 0, n - 1), (p >= 0) & (p < n)

    (x0, okx0), (x1, okx1) = taps(ix, w), taps(ix + 1, w)
    (y0, oky0), (y1, oky1) = taps(iy, h), taps(iy + 1, h)
    extra = (None,) * (src.ndim - 2)

    def px(yy, xx, ok):
        return np.where(ok[(...,) + extra], src[yy, xx].astype(np.float32), np.float32(value))

    p00, p01 = px(y0, x0, oky0 & okx0), px(y0, x1, oky0 & okx1)
    p10, p11 = px(y1, x0, oky1 & okx0), px(y1, x1, oky1 & okx1)
    a, b = a[(...,) + extra], b[(...,) + extra]
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    return np.clip(np.rint(fma32(b, v1 - v0, v0)), 0, 255).astype(np.uint8)
