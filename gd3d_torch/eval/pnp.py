"""OpenCV's EPnP RANSAC in numpy: `solve_pnp_ransac` returns what
`cv2.solvePnPRansac(obj, img, K, None, flags=cv2.SOLVEPNP_EPNP)` returns
(OpenCV 5.0.0), and `solve_pose` is gd3d/eval/onepose.py::solve_pose on it.

OpenCV's RANSAC is deterministic. Its generator is `cv::RNG` seeded with
2^64 - 1 on each call, so the 5-point subsets depend only on the point count.
Everything else is double arithmetic that this module repeats operation for
operation, so that a hypothesis scores the same inliers as in OpenCV:

- the points are cast to float32 first;
- each hypothesis is EPnP (Lepetit et al.) on 5 points, as OpenCV's epnp.cpp
  computes it: undistortPoints (float32), the control points from the
  centroid and a PCA, barycentric coordinates through an SVD inverse, the
  12 x 12 M^T M and its last four left singular vectors, betas for N = 1, 2, 3
  each refined by five Gauss-Newton steps (a Householder QR), the N with the
  least mean reprojection error, then Rodrigues;
- every SVD is OpenCV's one-sided Jacobi (lapack.cpp's JacobiSVDImpl_ with
  its own hypot); OpenCV uses it below 25 rows, where it does not call
  LAPACK. Its null vectors (5 points leave M^T M two of them) are the
  rounding noise of the rotations, so nothing but the same operations in the
  same order reproduces them;
- a point is an inlier when the float32 squared pixel error of projectPoints
  is at most (float)(8^2); a model replaces the best one when its count
  exceeds max(best, 4), and the iteration limit shrinks by
  RANSACUpdateNumIters(0.99, ...);
- the final pose is EPnP on all inliers, in double from the float32 points.

The hypotheses are computed in batches of subsets, vectorized over the
batch; OpenCV's sequential choice of the best model and its early stop are
then replayed on the batch's inlier counts, so the result is the sequential
one. `tests/test_torch_pnp.py` holds this module to cv2 and to the records
in `gd3d_torch/eval/testdata/pnp_cv2.npz`.

Cases: 4 points are OpenCV's P3P (Gao's solver), which this module does not
carry: `solve_pnp_ransac` raises for them, and `solve_pose` returns the
identity there, as gd3d does for any result with 5 or fewer inliers. Exactly 5
points are one EPnP on all of them, all inliers. No model with 5 or more
inliers gives retval False and no inliers; cv2's rvec and tvec are then
whatever its buffers held, and this module returns zeros. Collinear or repeated points give NaN hypotheses, which score no
inliers.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np

DBL_EPSILON = float(np.finfo(np.float64).eps)
DBL_MIN = float(np.finfo(np.float64).tiny)
RNG_COEFF = 4164903690
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
MODEL_POINTS = 5  # EPnP's minimal sample in OpenCV's RANSAC
CONFIDENCE = 0.99  # solvePnPRansac's default, which gd3d keeps
CHUNK_ELEMS = 1 << 22  # projections computed at once when scoring hypotheses


# ------------------------------------------------------------------ cv::RNG
class CvRng:
    """cv::RNG: multiply-with-carry on a 64-bit state."""

    def __init__(self, state: int = MASK64):
        self.state = (state & MASK64) or MASK32

    def next(self) -> int:
        s = self.state
        s = ((s & MASK32) * RNG_COEFF + (s >> 32)) & MASK64
        self.state = s
        return s & MASK32

    def uniform(self, n: int) -> int:
        """rng.uniform(0, n) for ints: (unsigned) next() % n."""
        return self.next() % n


def subsets(count: int) -> Iterator[Tuple[int, ...]]:
    """The RANSAC registrator's 5-point subsets of `count` points in order
    (getSubset: distinct indices, a repeat drawn again; PnP's callback
    accepts every subset). The sequence depends on nothing but `count`."""
    rng = CvRng()
    while True:
        idx: list = []
        for _ in range(MODEL_POINTS):
            i = rng.uniform(count)
            while i in idx:
                i = rng.uniform(count)
            idx.append(i)
        yield tuple(idx)


def ransac_update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """cv::RANSACUpdateNumIters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, DBL_MIN)
    denom = 1.0 - math.pow(1.0 - ep, model_points)
    if denom < DBL_MIN:
        return 0
    num = math.log(num)
    denom = math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return cv_round(num / denom)


def cv_round(x: float) -> int:
    """cvRound: to nearest, ties to even (the SSE2 conversion)."""
    return int(np.rint(x))


# ------------------------------------------------------------ Jacobi SVD
def _cv_hypot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """lapack.cpp's hypot: big * sqrt(1 + (small / big)^2), 0 for (0, 0)."""
    a, b = np.abs(a), np.abs(b)
    big, small = np.maximum(a, b), np.minimum(a, b)
    with np.errstate(invalid="ignore", divide="ignore"):
        q = small / big
        return np.where(big > 0, big * np.sqrt(1 + q * q), 0.0)


def _sum_products(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """sum_k x[..., k] * y[..., k], added in k order from 0 (a C loop; an
    accumulate adds in order, where a reduction may pair the terms)."""
    return np.add.accumulate(x * y, axis=-1)[..., -1]


def jacobi_svd(at: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JacobiSVDImpl_ over a batch: `at` (B, n, m) holds the columns of the
    matrix as rows. Returns W (B, n) descending, the normalized rotated rows
    (B, n, m) (the left singular vectors) and Vt (B, n, n).

    A rotation skipped by one item of the batch leaves it bit for bit as it
    was, and a sweep with no rotation would repeat as none, so each sweep runs
    on the items whose last sweep rotated, and each item ends as alone. The
    work runs on (n, m, B) copies, the batch innermost."""
    B, n, m = np.shape(at)
    eps = DBL_EPSILON * 10
    A = np.ascontiguousarray(np.transpose(np.asarray(at, np.float64), (1, 2, 0)))
    V = np.broadcast_to(np.eye(n)[:, :, None], (n, n, B)).copy()
    W = np.stack([_sum_rows(A[i] * A[i]) for i in range(n)])
    live = np.arange(B)  # the items whose last sweep rotated
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for _ in range(max(m, 30)):
            if not len(live):
                break
            full = len(live) == B
            sa, sw, sv = (A, W, V) if full else (A[..., live], W[:, live], V[..., live])
            changed = np.zeros(len(live), bool)
            for i in range(n - 1):
                for j in range(i + 1, n):
                    ai, aj = sa[i], sa[j]
                    a, b = sw[i], sw[j]
                    p = _sum_rows(ai * aj)
                    rot = ~(np.abs(p) <= eps * np.sqrt(a * b))
                    if not rot.any():
                        continue
                    changed |= rot
                    p = p * 2
                    beta = a - b
                    gamma = _cv_hypot(p, beta)
                    neg = beta < 0
                    s_neg = np.sqrt(((gamma - beta) * 0.5) / gamma)
                    c_pos = np.sqrt((gamma + beta) / (gamma * 2))
                    c = np.where(neg, p / (gamma * s_neg * 2), c_pos)
                    s = np.where(neg, s_neg, p / (gamma * c_pos * 2))
                    t0 = c * ai + s * aj
                    t1 = -s * ai + c * aj
                    sw[i] = np.where(rot, _sum_rows(t0 * t0), a)
                    sw[j] = np.where(rot, _sum_rows(t1 * t1), b)
                    sa[i] = np.where(rot, t0, ai)
                    sa[j] = np.where(rot, t1, aj)
                    vi, vj = sv[i], sv[j]
                    v0 = c * vi + s * vj
                    v1 = -s * vi + c * vj
                    sv[i] = np.where(rot, v0, vi)
                    sv[j] = np.where(rot, v1, vj)
            if not full:
                A[..., live], W[:, live], V[..., live] = sa, sw, sv
            live = live[changed]
    at = np.ascontiguousarray(np.transpose(A, (2, 0, 1)))
    vt = np.ascontiguousarray(np.transpose(V, (2, 0, 1)))
    w = np.stack([np.sqrt(_sum_products(at[:, i], at[:, i])) for i in range(n)], 1)
    rows = np.arange(B)
    for i in range(n - 1):  # selection sort, the first of equal maxima
        j = i + np.argmax(w[:, i:], axis=1)
        sw_ = rows[j != i]
        if len(sw_):
            js = j[sw_]
            for arr in (w, at, vt):
                tmp = arr[sw_, i].copy()
                arr[sw_, i] = arr[sw_, js]
                arr[sw_, js] = tmp
    for i in range(n):
        sd = w[:, i]
        low = sd <= DBL_MIN
        if low.any():
            sd = sd.copy()
            for b_ in np.nonzero(low)[0]:
                sd[b_] = _random_left_vector(at[b_], i, m)
        with np.errstate(divide="ignore"):
            scale = np.where(sd > DBL_MIN, 1 / sd, 0.0)
        at[:, i] = at[:, i] * scale[:, None]
    return w, at, vt


def _sum_rows_b(x: np.ndarray) -> np.ndarray:
    """sum_i x[:, i] over the second axis, in order."""
    return np.add.accumulate(x, axis=1)[:, -1]


def _sum_rows(x: np.ndarray) -> np.ndarray:
    """sum_k x[k] over the first axis, in order (an accumulate)."""
    return np.add.accumulate(x, axis=0)[-1]


def _random_left_vector(at: np.ndarray, i: int, m: int) -> float:
    """JacobiSVDImpl_'s left vector for a zero singular value: a random
    +-1/m vector (cv::RNG(0x12345678)) made orthogonal to the rows above it,
    in place. Returns its norm."""
    rng = CvRng(0x12345678)
    eps = DBL_EPSILON * 10
    sd = 0.0
    for _ in range(100):
        val0 = 1.0 / m
        for k in range(m):
            at[i, k] = val0 if (rng.next() & 256) != 0 else -val0
        for _ in range(2):
            for j in range(i):
                sd = 0.0
                for k in range(m):
                    sd = sd + at[i, k] * at[j, k]
                asum = 0.0
                for k in range(m):
                    t = at[i, k] - sd * at[j, k]
                    at[i, k] = t
                    asum = asum + abs(t)
                asum = 1 / asum if asum > eps * 100 else 0.0
                for k in range(m):
                    at[i, k] = at[i, k] * asum
        sd = 0.0
        for k in range(m):
            sd = sd + at[i, k] * at[i, k]
        sd = math.sqrt(sd)
        if sd > DBL_MIN:
            break
    return sd


def svd(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv::SVD::compute of a batch a (B, m, n), m >= n: w (B, n), u (B, m, n),
    vt (B, n, n)."""
    a = np.asarray(a, np.float64)
    if a.shape[1] < a.shape[2]:
        raise ValueError(f"svd takes m >= n, got {a.shape[1:]}")
    w, u_rows, vt = jacobi_svd(np.swapaxes(a, 1, 2))
    return w, np.swapaxes(u_rows, 1, 2), vt


def _back_subst_1(w, u_rows, v_rows, b) -> np.ndarray:
    """SVBkSb for one right-hand side: x = sum_i v_i (u_i . b) / w_i over the
    w_i above sum(w) * 2 DBL_EPSILON."""
    B, nm = w.shape
    x = np.zeros((B, v_rows.shape[2]))
    threshold = w[:, 0].copy()
    for i in range(1, nm):
        threshold = threshold + w[:, i]
    threshold = threshold * (DBL_EPSILON * 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(nm):
            wi = w[:, i]
            live = ~(np.abs(wi) <= threshold)
            s = _sum_products(u_rows[:, i], b) * (1 / wi)
            x = np.where(live[:, None], x + s[:, None] * v_rows[:, i], x)
    return x


def solve_svd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv::solve(a, b, x, DECOMP_SVD) for a batch a (B, m, n), m >= n, and
    b (B, m): the least-squares x (B, n)."""
    w, u_rows, vt = jacobi_svd(np.swapaxes(np.asarray(a, np.float64), 1, 2))
    return _back_subst_1(w, u_rows, vt, b)


def invert_svd(a: np.ndarray) -> np.ndarray:
    """cv::invert(a, DECOMP_SVD) for a batch of square a (B, n, n)."""
    w, u, vt = svd(a)
    B, n, _ = u.shape
    thr = w[:, 0].copy()
    for i in range(1, n):
        thr = thr + w[:, i]
    thr = thr * (DBL_EPSILON * 2)
    x = np.zeros((B, n, n))
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(n):
            wi = w[:, i]
            live = ~(np.abs(wi) <= thr)
            buf = u[:, :, i] * (1 / wi)[:, None]  # (B, n): u's column i over w_i
            x = np.where(live[:, None, None], x + vt[:, i, :, None] * buf[:, None, :], x)
    return x


def mul_transposed(m: np.ndarray) -> np.ndarray:
    """cv::mulTransposed(m, dst, aTa=true) for a batch (B, r, c): each entry
    a sum over the rows in order."""
    B, r, c = m.shape
    out = np.empty((B, c, c))
    for i in range(c):
        for j in range(i, c):
            out[:, i, j] = out[:, j, i] = _sum_products(m[:, :, i], m[:, :, j])
    return out


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# ------------------------------------------------------------ Rodrigues
def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """cv::Rodrigues of rotation vectors (B, 3) -> (B, 3, 3)."""
    rvec = np.asarray(rvec, np.float64)
    x, y, z = rvec[:, 0], rvec[:, 1], rvec[:, 2]
    theta = np.sqrt(x * x + y * y + z * z)
    c = np.array([math.cos(t) for t in theta])
    s = np.array([math.sin(t) for t in theta])
    c1 = 1.0 - c
    with np.errstate(divide="ignore", invalid="ignore"):
        itheta = np.where(theta != 0, 1.0 / theta, 0.0)
    x, y, z = x * itheta, y * itheta, z * itheta
    rrt = [[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]]
    zero = np.zeros_like(x)
    rx = [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    R = np.empty((len(theta), 3, 3))
    for i in range(3):
        for j in range(3):
            R[:, i, j] = (c * float(i == j) + c1 * rrt[i][j]) + s * rx[i][j]
    return np.where((theta < DBL_EPSILON)[:, None, None], np.eye(3), R)


def rodrigues_to_vector(R: np.ndarray) -> np.ndarray:
    """cv::Rodrigues of rotation matrices (B, 3, 3) -> (B, 3): the nearest
    rotation U Vt first, then the angle from its trace."""
    R = np.asarray(R, np.float64)
    out = np.zeros((len(R), 3))
    finite = np.all(np.isfinite(R) & (np.abs(R) <= 100), axis=(1, 2))
    if not finite.any():
        return out
    idx = np.nonzero(finite)[0]
    _, u, vt = svd(R[idx])
    Rn = np.empty_like(u)
    for i in range(3):
        for j in range(3):
            Rn[:, i, j] = _sum_products(u[:, i, :], vt[:, :, j])
    for b, Rb in zip(idx, Rn):
        out[b] = _rodrigues_vector_1(Rb)
    return out


def _rodrigues_vector_1(R: np.ndarray) -> np.ndarray:
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = math.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = (R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5
    c = 1.0 if c > 1.0 else -1.0 if c < -1.0 else c
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        t = (R[0, 0] + 1) * 0.5
        rx = math.sqrt(max(t, 0.0))
        t = (R[1, 1] + 1) * 0.5
        ry = math.sqrt(max(t, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        t = (R[2, 2] + 1) * 0.5
        rz = math.sqrt(max(t, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (R[1, 2] > 0) != (ry * rz > 0):
            rz = -rz
        theta /= math.sqrt(rx * rx + ry * ry + rz * rz)
        return np.array([rx * theta, ry * theta, rz * theta])
    vth = 1 / (2 * s)
    vth *= theta
    return np.array([rx * vth, ry * vth, rz * vth])


# ------------------------------------------------------------ projection
def project_points(obj: np.ndarray, rvec: np.ndarray, tvec: np.ndarray,
                   K: np.ndarray) -> np.ndarray:
    """cv::projectPoints with no distortion, for a batch of poses: obj
    (N, 3), rvec and tvec (B, 3) -> (B, N, 2) float32 pixels."""
    R = rodrigues_to_matrix(rvec)
    X, Y, Z = (np.asarray(obj, np.float64)[None, :, k] for k in range(3))
    t = np.asarray(tvec, np.float64)
    r = R.reshape(-1, 9)[:, :, None]
    x = r[:, 0] * X + r[:, 1] * Y + r[:, 2] * Z + t[:, 0, None]
    y = r[:, 3] * X + r[:, 4] * Y + r[:, 5] * Z + t[:, 1, None]
    z = r[:, 6] * X + r[:, 7] * Y + r[:, 8] * Z + t[:, 2, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(z != 0, 1.0 / z, 1.0)
    x, y = x * z, y * z
    u = (x * K[0, 0] + K[0, 2]).astype(np.float32)
    v = (y * K[1, 1] + K[1, 2]).astype(np.float32)
    return np.stack([u, v], -1)


# ------------------------------------------------------------ EPnP
def epnp(obj: np.ndarray, img: np.ndarray, K: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cv::solvePnP(SOLVEPNP_EPNP) for a batch: obj (B, n, 3) and img
    (B, n, 2), both float32 or both float64 (the dtype of undistortPoints'
    output). Returns rvec (B, 3) and tvec (B, 3)."""
    K = np.asarray(K, np.float64)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    img64 = np.asarray(img).astype(np.float64)
    und = np.stack([(img64[..., 0] - uc) * (1.0 / fu), (img64[..., 1] - vc) * (1.0 / fv)], -1)
    und = und.astype(np.asarray(img).dtype).astype(np.float64)
    pws = np.asarray(obj).astype(np.float64)
    us = np.stack([und[..., 0] * fu + uc, und[..., 1] * fv + vc], -1)
    B, n, _ = pws.shape

    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        # control points: the centroid, then the principal axes
        cw0 = _sum_rows_b(pws) / n
        dc, uct_rows = _svd_u_rows(mul_transposed(pws - cw0[:, None]))
        cws = [cw0] + [cw0 + np.sqrt(dc[:, i] / n)[:, None] * uct_rows[:, i] for i in range(3)]
        # barycentric coordinates
        cc = np.stack([cws[j][:, :] - cw0 for j in (1, 2, 3)], 2)  # cc[:, i, j-1] = cws[j][i] - cws[0][i]
        ci = invert_svd(cc)
        d = pws - cw0[:, None]
        alphas = np.empty((B, n, 4))
        for j in range(3):
            alphas[..., 1 + j] = (ci[:, j, 0, None] * d[..., 0] + ci[:, j, 1, None] * d[..., 1]
                                  + ci[:, j, 2, None] * d[..., 2])
        alphas[..., 0] = 1.0 - alphas[..., 1] - alphas[..., 2] - alphas[..., 3]
        # M (2n x 12), M^T M and its left singular vectors
        M = np.zeros((B, 2 * n, 12))
        for i in range(4):
            a = alphas[..., i]
            M[:, 0::2, 3 * i] = a * fu
            M[:, 0::2, 3 * i + 2] = a * (uc - us[..., 0])
            M[:, 1::2, 3 * i + 1] = a * fv
            M[:, 1::2, 3 * i + 2] = a * (vc - us[..., 1])
        _, ut = _svd_u_rows(mul_transposed(M))
        L = _l_6x10(ut)
        rho = _rho(cws)
        best = None
        for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
            betas = _gauss_newton(L, rho, approx(L, rho))
            R, t, err = _compute_r_and_t(ut, betas, alphas, pws, us, fu, fv, uc, vc)
            if best is None:
                best = (R, t, err)
            else:  # rep_errors[N] < rep_errors[best]: the later N wins only when smaller
                take = err < best[2]
                best = (np.where(take[:, None, None], R, best[0]),
                        np.where(take[:, None], t, best[1]), np.where(take, err, best[2]))
    R, t, _ = best
    return rodrigues_to_vector(R), t


def _svd_u_rows(a):
    """cvSVD(a, D, Ut, 0, CV_SVD_U_T) of square a: (w, the rows of U^T)."""
    w, u_rows, _ = jacobi_svd(np.swapaxes(a, 1, 2))
    return w, u_rows


def _l_6x10(ut):
    v = [ut[:, 11], ut[:, 10], ut[:, 9], ut[:, 8]]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dv = [[v[i][:, 3 * a:3 * a + 3] - v[i][:, 3 * b:3 * b + 3] for a, b in pairs] for i in range(4)]
    L = np.empty((ut.shape[0], 6, 10))
    for r in range(6):
        d0, d1, d2, d3 = dv[0][r], dv[1][r], dv[2][r], dv[3][r]
        L[:, r, 0] = _dot3(d0, d0)
        L[:, r, 1] = 2.0 * _dot3(d0, d1)
        L[:, r, 2] = _dot3(d1, d1)
        L[:, r, 3] = 2.0 * _dot3(d0, d2)
        L[:, r, 4] = 2.0 * _dot3(d1, d2)
        L[:, r, 5] = _dot3(d2, d2)
        L[:, r, 6] = 2.0 * _dot3(d0, d3)
        L[:, r, 7] = 2.0 * _dot3(d1, d3)
        L[:, r, 8] = 2.0 * _dot3(d2, d3)
        L[:, r, 9] = _dot3(d3, d3)
    return L


def _rho(cws):
    def dist2(p, q):
        d = p - q
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]

    return np.stack([dist2(cws[0], cws[1]), dist2(cws[0], cws[2]), dist2(cws[0], cws[3]),
                     dist2(cws[1], cws[2]), dist2(cws[1], cws[3]), dist2(cws[2], cws[3])], 1)


def _betas_approx_1(L, rho):
    b4 = solve_svd(L[:, :, [0, 1, 3, 6]], rho)
    neg = b4[:, 0] < 0
    b0 = np.sqrt(np.where(neg, -b4[:, 0], b4[:, 0]))
    sign = np.where(neg, -1.0, 1.0)
    return np.stack([b0, (sign * b4[:, 1]) / b0, (sign * b4[:, 2]) / b0, (sign * b4[:, 3]) / b0], 1)


def _betas_approx_2(L, rho):
    b3 = solve_svd(L[:, :, [0, 1, 2]], rho)
    neg = b3[:, 0] < 0
    b0 = np.sqrt(np.where(neg, -b3[:, 0], b3[:, 0]))
    b1 = np.where(neg, np.where(b3[:, 2] < 0, np.sqrt(-b3[:, 2]), 0.0),
                  np.where(b3[:, 2] > 0, np.sqrt(b3[:, 2]), 0.0))
    b0 = np.where(b3[:, 1] < 0, -b0, b0)
    z = np.zeros_like(b0)
    return np.stack([b0, b1, z, z], 1)


def _betas_approx_3(L, rho):
    b5 = solve_svd(L[:, :, [0, 1, 2, 3, 4]], rho)
    neg = b5[:, 0] < 0
    b0 = np.sqrt(np.where(neg, -b5[:, 0], b5[:, 0]))
    b1 = np.where(neg, np.where(b5[:, 2] < 0, np.sqrt(-b5[:, 2]), 0.0),
                  np.where(b5[:, 2] > 0, np.sqrt(b5[:, 2]), 0.0))
    b0 = np.where(b5[:, 1] < 0, -b0, b0)
    return np.stack([b0, b1, b5[:, 3] / b0, np.zeros_like(b0)], 1)


def _gauss_newton(L, rho, betas):
    betas = betas.copy()
    x = np.zeros_like(betas)
    for _ in range(5):
        b = betas
        A = np.empty((len(b), 6, 4))
        rhs = np.empty((len(b), 6))
        for i in range(6):
            r = L[:, i]
            A[:, i, 0] = 2 * r[:, 0] * b[:, 0] + r[:, 1] * b[:, 1] + r[:, 3] * b[:, 2] + r[:, 6] * b[:, 3]
            A[:, i, 1] = r[:, 1] * b[:, 0] + 2 * r[:, 2] * b[:, 1] + r[:, 4] * b[:, 2] + r[:, 7] * b[:, 3]
            A[:, i, 2] = r[:, 3] * b[:, 0] + r[:, 4] * b[:, 1] + 2 * r[:, 5] * b[:, 2] + r[:, 8] * b[:, 3]
            A[:, i, 3] = r[:, 6] * b[:, 0] + r[:, 7] * b[:, 1] + r[:, 8] * b[:, 2] + 2 * r[:, 9] * b[:, 3]
            rhs[:, i] = rho[:, i] - (
                r[:, 0] * b[:, 0] * b[:, 0] + r[:, 1] * b[:, 0] * b[:, 1]
                + r[:, 2] * b[:, 1] * b[:, 1] + r[:, 3] * b[:, 0] * b[:, 2]
                + r[:, 4] * b[:, 1] * b[:, 2] + r[:, 5] * b[:, 2] * b[:, 2]
                + r[:, 6] * b[:, 0] * b[:, 3] + r[:, 7] * b[:, 1] * b[:, 3]
                + r[:, 8] * b[:, 2] * b[:, 3] + r[:, 9] * b[:, 3] * b[:, 3])
        x = _qr_solve(A, rhs, x)
        betas = betas + x
    return betas


def _qr_solve(A, b, x_prev):
    """epnp::qr_solve (Householder) of 6 x 4 systems. An all-zero column
    leaves x as it was (OpenCV returns early)."""
    A, b = A.copy(), b.copy()
    B, nr, nc = A.shape
    A1 = np.zeros((B, nc))
    A2 = np.zeros((B, nc))
    singular = np.zeros(B, bool)
    for k in range(nc):
        # OpenCV's scan reads rows k .. nr - 2 (its pointer lags the index)
        eta = np.abs(A[:, k, k])
        for i in range(k, nr - 1):
            eta = np.where(eta < np.abs(A[:, i, k]), np.abs(A[:, i, k]), eta)
        singular |= eta == 0
        inv_eta = 1.0 / np.where(eta == 0, 1.0, eta)
        A[:, k:, k] = A[:, k:, k] * inv_eta[:, None]
        sum2 = A[:, k, k] * A[:, k, k]
        for i in range(k + 1, nr):
            sum2 = sum2 + A[:, i, k] * A[:, i, k]
        sigma = np.sqrt(sum2)
        sigma = np.where(A[:, k, k] < 0, -sigma, sigma)
        A[:, k, k] = A[:, k, k] + sigma
        A1[:, k] = sigma * A[:, k, k]
        A2[:, k] = -eta * sigma
        for j in range(k + 1, nc):
            s = A[:, k, k] * A[:, k, j]
            for i in range(k + 1, nr):
                s = s + A[:, i, k] * A[:, i, j]
            tau = s / A1[:, k]
            A[:, k:, j] = A[:, k:, j] - tau[:, None] * A[:, k:, k]
    for j in range(nc):
        tau = A[:, j, j] * b[:, j]
        for i in range(j + 1, nr):
            tau = tau + A[:, i, j] * b[:, i]
        tau = tau / A1[:, j]
        b[:, j:] = b[:, j:] - tau[:, None] * A[:, j:, j]
    x = np.empty((B, nc))
    x[:, nc - 1] = b[:, nc - 1] / A2[:, nc - 1]
    for i in range(nc - 2, -1, -1):
        s = A[:, i, i + 1] * x[:, i + 1]
        for j in range(i + 2, nc):
            s = s + A[:, i, j] * x[:, j]
        x[:, i] = (b[:, i] - s) / A2[:, i]
    return np.where(singular[:, None], x_prev, x)


def _compute_r_and_t(ut, betas, alphas, pws, us, fu, fv, uc, vc):
    B, n, _ = pws.shape
    ccs = np.zeros((B, 4, 3))
    for i in range(4):
        v = ut[:, 11 - i].reshape(B, 4, 3)
        ccs = ccs + betas[:, i, None, None] * v
    pcs = (alphas[..., 0, None] * ccs[:, None, 0] + alphas[..., 1, None] * ccs[:, None, 1]
           + alphas[..., 2, None] * ccs[:, None, 2] + alphas[..., 3, None] * ccs[:, None, 3])
    pcs = np.where((pcs[:, 0, 2] < 0)[:, None, None], -pcs, pcs)  # solve_for_sign
    pc0, pw0 = _sum_rows_b(pcs) / n, _sum_rows_b(pws) / n
    dc = pcs - pc0[:, None]
    dw = pws - pw0[:, None]
    abt = _sum_rows_b(dc[:, :, :, None] * dw[:, :, None, :])
    w, u, vt = svd(abt)
    R = np.empty((B, 3, 3))
    for i in range(3):
        for j in range(3):
            R[:, i, j] = _dot3(u[:, i, :], vt[:, :, j])
    det = (R[:, 0, 0] * R[:, 1, 1] * R[:, 2, 2] + R[:, 0, 1] * R[:, 1, 2] * R[:, 2, 0]
           + R[:, 0, 2] * R[:, 1, 0] * R[:, 2, 1] - R[:, 0, 2] * R[:, 1, 1] * R[:, 2, 0]
           - R[:, 0, 1] * R[:, 1, 0] * R[:, 2, 2] - R[:, 0, 0] * R[:, 1, 2] * R[:, 2, 1])
    R[:, 2] = np.where((det < 0)[:, None], -R[:, 2], R[:, 2])
    t = pc0 - np.stack([_dot3(R[:, i], pw0) for i in range(3)], 1)
    Xc = _dot3(R[:, None, 0], pws) + t[:, 0, None]
    Yc = _dot3(R[:, None, 1], pws) + t[:, 1, None]
    inv_zc = 1.0 / (_dot3(R[:, None, 2], pws) + t[:, 2, None])
    ue = uc + fu * Xc * inv_zc
    ve = vc + fv * Yc * inv_zc
    du, dv = us[..., 0] - ue, us[..., 1] - ve
    return R, t, _sum_rows_b(np.sqrt(du * du + dv * dv)) / n


# ------------------------------------------------------------ RANSAC
def reprojection_errors(obj32: np.ndarray, img32: np.ndarray, rvec: np.ndarray, tvec: np.ndarray,
                        K: np.ndarray) -> np.ndarray:
    """PnPRansacCallback::computeError for a batch of models: the float32
    squared pixel distance of each point to its projection, (B, N)."""
    B, N = len(rvec), len(obj32)
    out = np.empty((B, N), np.float32)
    step = max(1, CHUNK_ELEMS // max(N, 1))
    with np.errstate(invalid="ignore", over="ignore"):
        for lo in range(0, B, step):
            proj = project_points(obj32, rvec[lo:lo + step], tvec[lo:lo + step], K)
            d = img32[None] - proj
            out[lo:lo + step] = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return out


def solve_pnp_ransac(obj: np.ndarray, img: np.ndarray, K: np.ndarray,
                     reprojection_error: float = 8.0, iterations: int = 10000,
                     stats: Optional[dict] = None):
    """cv2.solvePnPRansac(obj, img, K, None, iterationsCount=iterations,
    reprojectionError=reprojection_error,
    flags=cv2.SOLVEPNP_EPNP). Returns (retval, rvec (3, 1), tvec (3, 1),
    inliers (k, 1) int32 or None), as cv2 does. `stats`, when given, gets
    iterations (the hypotheses OpenCV scores), hypotheses (the ones
    computed, batches rounded up) and best (the best inlier count)."""
    obj32 = np.asarray(obj).astype(np.float32).reshape(-1, 3)
    img32 = np.asarray(img).astype(np.float32).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(obj32)
    if n < 4 or len(img32) != n:
        raise ValueError(f"solvePnPRansac needs >= 4 matching points, got {n} and {len(img32)}")
    if n == 4:
        raise NotImplementedError("4 points take OpenCV's P3P, which this module does not carry")
    if n == MODEL_POINTS:  # one EPnP on all of them, no RANSAC
        if stats is not None:
            stats.update(iterations=0, hypotheses=1, best=5)
        rvec, tvec = epnp(obj32[None], img32[None], K)
        return True, rvec[0].reshape(3, 1), tvec[0].reshape(3, 1), np.arange(5, dtype=np.int32)[:, None]
    thr = np.float32(float(np.float32(reprojection_error)) ** 2)
    draws = subsets(n)
    niters, it = max(iterations, 1), 0
    best_count, best_model = 0, None
    batch, computed = 64, 0
    while it < niters:
        size = min(batch, niters - it)
        idx = np.array([next(draws) for _ in range(size)])
        rvec, tvec = epnp(obj32[idx], img32[idx], K)
        computed += size
        counts = (reprojection_errors(obj32, img32, rvec, tvec, K) <= thr).sum(1)
        for b in range(size):
            if it >= niters:
                break
            it += 1
            if counts[b] > max(best_count, 4):
                best_count, best_model = int(counts[b]), (rvec[b].copy(), tvec[b].copy())
                niters = ransac_update_num_iters(CONFIDENCE, (n - best_count) / n,
                                                 MODEL_POINTS, niters)
        batch = min(batch * 2, 2048)
    if stats is not None:
        stats.update(iterations=it, hypotheses=computed, best=best_count)
    if best_model is None:  # cv2 leaves rvec and tvec as its buffers were
        return False, np.zeros((3, 1)), np.zeros((3, 1)), None
    mask = reprojection_errors(obj32, img32, best_model[0][None], best_model[1][None], K)[0] <= thr
    inl = np.nonzero(mask)[0]
    rvec, tvec = epnp(obj32[inl][None].astype(np.float64), img32[inl][None].astype(np.float64), K)
    return True, rvec[0].reshape(3, 1), tvec[0].reshape(3, 1), inl.astype(np.int32)[:, None]


def solve_pose(kp2d: np.ndarray, pts3d: np.ndarray, K: np.ndarray, reproj_px: float = 8.0,
               iterations: int = 10000, pts3d_scale: float = 1000.0,
               stats: Optional[dict] = None) -> np.ndarray:
    """gd3d/eval/onepose.py::solve_pose: EPnP RANSAC on the 3D points in
    millimetres, the translation back in metres; the 4 x 4 pose, or the
    identity with fewer than 4 points or 5 or fewer inliers."""
    pose = np.eye(4)
    if len(kp2d) < 4:
        return pose
    if len(kp2d) <= 5:  # cv2 returns every point as an inlier: at most 5
        return pose
    ok, r_exp, trans, inliers = solve_pnp_ransac(pts3d * pts3d_scale, kp2d.reshape(-1, 1, 2), K,
                                                 reproj_px, iterations, stats=stats)
    trans = trans / pts3d_scale
    if inliers is not None and len(inliers) > 5:
        R = rodrigues_to_matrix(r_exp.reshape(1, 3))[0]
        pose = np.concatenate([np.concatenate([R, trans], axis=-1), [[0, 0, 0, 1]]], axis=0)
    return pose
