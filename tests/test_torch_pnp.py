"""The port's EPnP RANSAC (gd3d_torch/eval/pnp.py) against cv2 5.0.0, which
gd3d's OnePose++ evaluation calls (gd3d/eval/onepose.py::solve_pose):

- its parts, bit for bit: the Jacobi SVD (cv2.SVDecomp), cv2.solve and
  cv2.invert with DECOMP_SVD, mulTransposed, Rodrigues both ways,
  projectPoints, and EPnP (cv2.solvePnP) on float32 and float64 points;
- solve_pnp_ransac against cv2.solvePnPRansac(EPNP, 8 px, 10000 iterations)
  on ~40 seeded scenes (4 to 20 000 points, 0 to 100% outliers, pixel noise,
  collinear, planar, repeated and behind-the-camera points): the same
  retval, the same inlier set, poses within 1e-6 of the vector's norm;
- solve_pose against gd3d's within 1e-6;
- the committed records gd3d_torch/eval/testdata/pnp_cv2.npz (the card's
  machine has no cv2; chip_smoke.py holds the port to them) equal to what
  cv2 answers now on the same scenes. `python tests/test_torch_pnp.py`
  rewrites them.

4 points are cv2's P3P, which the port does not carry: solve_pnp_ransac
raises there, and solve_pose gives gd3d's identity.
"""
import os
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gd3d.eval.onepose import solve_pose as gd3d_solve_pose  # noqa: E402
from gd3d_torch.eval import pnp  # noqa: E402

RECORDS = os.path.join(ROOT, "gd3d_torch", "eval", "testdata", "pnp_cv2.npz")
K = np.array([[600.0, 0.0, 256.0], [0.0, 590.0, 250.0], [0.0, 0.0, 1.0]])

# (points, outlier share, pixel noise, kind)
SCENES = [
    (4, 0.0, 0.0, "object"), (5, 0.0, 0.5, "object"), (5, 0.4, 1.0, "object"),
    (6, 0.0, 0.0, "object"), (6, 0.5, 1.0, "object"), (7, 0.0, 1.0, "object"),
    (8, 0.25, 0.5, "object"), (10, 0.3, 1.0, "object"), (12, 0.0, 2.0, "object"),
    (16, 0.5, 0.5, "object"), (20, 0.0, 0.0, "object"), (20, 0.6, 1.0, "object"),
    (30, 0.1, 5.0, "object"), (50, 0.5, 1.0, "object"), (64, 0.8, 1.0, "object"),
    (100, 0.0, 0.5, "object"), (100, 0.3, 2.0, "object"), (150, 0.7, 1.0, "object"),
    (200, 0.5, 3.0, "object"), (300, 0.2, 1.0, "object"), (400, 0.0, 7.0, "object"),
    (500, 0.6, 2.0, "object"), (800, 0.4, 8.0, "object"), (1000, 0.9, 1.0, "object"),
    (1500, 0.5, 0.0, "object"), (2000, 0.75, 2.0, "object"), (3000, 0.85, 1.0, "object"),
    (5000, 0.3, 1.0, "object"), (10000, 0.5, 1.0, "object"), (20000, 0.2, 1.0, "object"),
    (20000, 0.6, 2.0, "object"), (50, 1.0, 0.0, "object"), (200, 1.0, 0.0, "object"),
    (20, 0.0, 0.0, "collinear"), (30, 0.3, 1.0, "collinear"), (50, 0.2, 1.0, "planar"),
    (12, 0.0, 0.0, "repeated"), (30, 0.0, 0.5, "behind"), (40, 0.2, 0.5, "tiny"),
]


def make_scene(i):
    """Scene i: 3D points (metres, an object 0.2 m across about 0.6 m from
    the camera), their pixels under a seeded pose plus noise, and outliers
    drawn uniformly over the 512 x 512 frame."""
    n, outliers, noise, kind = SCENES[i]
    rng = np.random.RandomState(1000 + i)
    pts = rng.uniform(-0.1, 0.1, (n, 3))
    if kind == "collinear":
        pts = rng.uniform(-0.1, 0.1, (n, 1)) * np.array([[1.0, 0.5, -0.3]])
    elif kind == "planar":
        pts[:, 2] = 0.0
    elif kind == "repeated":
        pts[n // 2:] = pts[: n - n // 2]
    elif kind == "tiny":
        pts *= 0.05
    rvec = rng.normal(0, 0.6, 3)
    tvec = np.array([rng.normal(0, 0.03), rng.normal(0, 0.03), 0.6])
    if kind == "behind":
        tvec[2] = 0.05
    R = pnp.rodrigues_to_matrix(rvec[None])[0]
    cam = pts @ R.T + tvec
    img = cam[:, :2] / cam[:, 2:3] * [K[0, 0], K[1, 1]] + K[:2, 2]
    img = img + rng.normal(0, 1, img.shape) * noise
    bad = rng.rand(n) < outliers
    img[bad] = rng.uniform(0, 512, (int(bad.sum()), 2))
    return pts, img


def cv2_answer(pts, img):
    """cv2's (retval, rvec, tvec, inliers); without a consensus cv2's rvec
    and tvec are whatever its buffers held, so they count as zeros."""
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        pts * 1000.0, img.reshape(-1, 1, 2), K, None, reprojectionError=8.0,
        iterationsCount=10000, flags=cv2.SOLVEPNP_EPNP)
    if not ok:
        rvec, tvec = np.zeros((3, 1)), np.zeros((3, 1))
    return bool(ok), rvec, tvec, (np.zeros((0, 1), np.int32) if inliers is None else inliers)


def write_records(path=RECORDS):
    out = {"K": K}
    for i in range(len(SCENES)):
        pts, img = make_scene(i)
        ok, rvec, tvec, inliers = cv2_answer(pts, img)
        out.update({f"s{i}_pts": pts, f"s{i}_img": img, f"s{i}_ok": np.array(ok),
                    f"s{i}_rvec": rvec, f"s{i}_tvec": tvec, f"s{i}_inliers": inliers,
                    f"s{i}_pose": gd3d_solve_pose(img, pts, K)})
    np.savez_compressed(path, **out)


@pytest.fixture(scope="module")
def records():
    return np.load(RECORDS)


_PORT = {}


def port_ransac(records, i):
    """The port's solve_pnp_ransac on scene i, computed once."""
    if i not in _PORT:
        pts, img = records[f"s{i}_pts"], records[f"s{i}_img"]
        _PORT[i] = pnp.solve_pnp_ransac(pts * 1000.0, img.reshape(-1, 1, 2), K, 8.0, 10000)
    return _PORT[i]


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    assert np.abs(got - want).max() <= tol * max(np.linalg.norm(want), 1e-12), (got, want)


@pytest.mark.parametrize("i", range(len(SCENES)))
def test_records_are_cv2s_answers_now(records, i):
    pts, img = make_scene(i)
    np.testing.assert_array_equal(records[f"s{i}_pts"], pts)
    np.testing.assert_array_equal(records[f"s{i}_img"], img)
    ok, rvec, tvec, inliers = cv2_answer(pts, img)
    assert bool(records[f"s{i}_ok"]) == ok
    np.testing.assert_array_equal(records[f"s{i}_rvec"], rvec)
    np.testing.assert_array_equal(records[f"s{i}_tvec"], tvec)
    np.testing.assert_array_equal(records[f"s{i}_inliers"], inliers)
    np.testing.assert_array_equal(records[f"s{i}_pose"], gd3d_solve_pose(img, pts, K))


@pytest.mark.parametrize("i", range(len(SCENES)))
def test_solve_pnp_ransac_matches_cv2(records, i):
    pts, img = records[f"s{i}_pts"], records[f"s{i}_img"]
    if len(pts) == 4:
        with pytest.raises(NotImplementedError, match="P3P"):
            pnp.solve_pnp_ransac(pts * 1000.0, img, K)
        return
    ok, rvec, tvec, inliers = port_ransac(records, i)
    assert ok == bool(records[f"s{i}_ok"])
    np.testing.assert_array_equal(np.zeros((0, 1), np.int32) if inliers is None else inliers,
                                  records[f"s{i}_inliers"])
    assert rvec.shape == tvec.shape == (3, 1)
    if not ok:
        assert inliers is None
        np.testing.assert_array_equal(np.hstack([rvec, tvec]), 0.0)
        return
    _close(rvec, records[f"s{i}_rvec"])
    _close(tvec, records[f"s{i}_tvec"])


@pytest.mark.parametrize("i", range(len(SCENES)))
def test_solve_pose_matches_gd3d(records, i, monkeypatch):
    """solve_pose on the RANSAC's answer (computed once per scene, with the
    arguments solve_pose passes)."""
    pts, img = records[f"s{i}_pts"], records[f"s{i}_img"]
    want = records[f"s{i}_pose"]
    if len(pts) > 5:
        def ransac(obj, kp, k, px, iters, stats=None):
            np.testing.assert_array_equal(obj, pts * 1000.0)
            np.testing.assert_array_equal(kp, img.reshape(-1, 1, 2))
            assert (px, iters) == (8.0, 10000)
            return port_ransac(records, i)

        monkeypatch.setattr(pnp, "solve_pnp_ransac", ransac)
    got = pnp.solve_pose(img, pts, K)
    assert got.shape == (4, 4)
    _close(got[:3, :3], want[:3, :3])
    _close(got[:3, 3], want[:3, 3])
    np.testing.assert_array_equal(got[3], [0, 0, 0, 1])


def test_solve_pose_degenerate_counts():
    """Fewer than 4 points, and 4 or 5 (every point cv2's inlier, never > 5):
    the identity, as gd3d's."""
    rng = np.random.RandomState(3)
    for n in (0, 3, 4, 5):
        pts, img = rng.rand(n, 3) + [0, 0, 1], rng.rand(n, 2) * 500
        np.testing.assert_array_equal(pnp.solve_pose(img, pts, K), np.eye(4))
        np.testing.assert_array_equal(gd3d_solve_pose(img, pts, K), np.eye(4))


@pytest.mark.parametrize("shape", [(12, 12), (3, 3), (6, 4), (6, 5), (6, 3), (2, 2),
                                   "zero columns", "zero"])
def test_jacobi_svd_is_cv2s(shape):
    """Exact zero singular values (5 copies of one 3D point give a zero
    PCA matrix) take JacobiSVDImpl_'s seeded random left vectors."""
    rng = np.random.RandomState(len(str(shape)))
    for _ in range(10):
        if shape == "zero columns":
            a = rng.randn(5, 4)
            a[:, [0, 2]] = 0.0
        elif shape == "zero":
            a = np.zeros((3, 3))
        else:
            a = rng.randn(*shape)
        if shape == (12, 12):  # M^T M of 5 points: a two-dimensional null space
            m = rng.randn(10, 12)
            a = m.T @ m
        w, u, vt = cv2.SVDecomp(a)
        gw, gu, gvt = (x[0] for x in pnp.svd(a[None]))
        np.testing.assert_array_equal(gw, w.ravel())
        np.testing.assert_array_equal(gu, u)
        np.testing.assert_array_equal(gvt, vt)


def test_solve_invert_multransposed_are_cv2s():
    rng = np.random.RandomState(5)
    for cols in (3, 4, 5):
        a, b = rng.randn(6, cols), rng.randn(6)
        want = cv2.solve(a, b.reshape(-1, 1), flags=cv2.DECOMP_SVD)[1].ravel()
        np.testing.assert_array_equal(pnp.solve_svd(a[None], b[None])[0], want)
    a = rng.randn(3, 3)
    np.testing.assert_array_equal(pnp.invert_svd(a[None])[0], cv2.invert(a, flags=cv2.DECOMP_SVD)[1])
    m = rng.randn(10, 12)
    np.testing.assert_array_equal(pnp.mul_transposed(m[None])[0], cv2.mulTransposed(m, True))


def test_rodrigues_and_projection_are_cv2s():
    rng = np.random.RandomState(6)
    for scale in (1e-3, 0.3, 2.0, 3.1):
        r = rng.randn(3) * scale
        R = cv2.Rodrigues(r)[0]
        np.testing.assert_array_equal(pnp.rodrigues_to_matrix(r[None])[0], R)
        noisy = R + rng.randn(3, 3) * 1e-4
        np.testing.assert_array_equal(pnp.rodrigues_to_vector(noisy[None])[0],
                                      cv2.Rodrigues(noisy)[0].ravel())
        obj = (rng.randn(50, 3) * 0.1 + [0, 0, 0.7]).astype(np.float32)
        t = rng.randn(3) * 0.05
        want = cv2.projectPoints(obj, r, t, K, None)[0].reshape(-1, 2)
        np.testing.assert_array_equal(pnp.project_points(obj, r[None], t[None], K)[0], want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [5, 6, 9, 40, 300])
def test_epnp_is_cv2s(n, dtype):
    rng = np.random.RandomState(n)
    for _ in range(4):
        obj = (rng.randn(n, 3) * 0.1 + [0, 0, 0.6]).astype(dtype)
        r, t = rng.randn(3) * 0.4, rng.randn(3) * 0.05
        img = cv2.projectPoints(obj.astype(np.float64), r, t, K, None)[0].reshape(-1, 2)
        img = (img + rng.randn(n, 2) * 2.0).astype(dtype)
        img[:2] += 40.0  # two outliers
        _, rv, tv = cv2.solvePnP(obj, img, K, None, flags=cv2.SOLVEPNP_EPNP)
        grv, gtv = pnp.epnp(obj[None], img[None], K)
        np.testing.assert_array_equal(grv[0], rv.ravel())
        np.testing.assert_array_equal(gtv[0], tv.ravel())


def test_rng_and_iteration_count():
    """cv::RNG((uint64)-1) and RANSACUpdateNumIters on known values."""
    rng = pnp.CvRng()
    assert rng.state == 2 ** 64 - 1
    first = rng.next()
    assert first == (((2 ** 32 - 1) * 4164903690 + (2 ** 32 - 1)) & (2 ** 64 - 1)) & (2 ** 32 - 1)
    subsets = pnp.subsets(10)
    for _ in range(50):
        s = next(subsets)
        assert len(set(s)) == 5 and all(0 <= i < 10 for i in s)
    assert pnp.ransac_update_num_iters(0.99, 0.0, 5, 10000) == 0
    assert pnp.ransac_update_num_iters(0.99, 0.9, 5, 10000) == 10000
    assert pnp.ransac_update_num_iters(0.99, 0.5, 5, 10000) == round(np.log(0.01) / np.log(1 - 0.5 ** 5))


if __name__ == "__main__":
    write_records()
    print("wrote", RECORDS)
