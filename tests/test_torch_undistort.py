"""The port's lens undistortion (gd3d_torch/data/undistort.py) and cv2's
INTER_NEAREST_EXACT (data/resample.py::resize_nearest_exact_cv) against
cv2 5.0.0, and the ScanNet++ preprocessor's undistort_image against gd3d's.

Every comparison is exact: undistortPoints, getOptimalNewCameraMatrix
(alpha 0 and 1, centred), initUndistortRectifyMap's float32 maps, the
fisheye new camera matrix and maps, and remap INTER_LINEAR on uint8 with
BORDER_REFLECT_101 and BORDER_CONSTANT (the largest map difference and the
count of differing pixels are asserted to be 0)."""
import cv2
import numpy as np
import pytest

from gd3d_torch.data import undistort as U
from gd3d_torch.data.resample import resize_nearest_exact_cv

# (width, height, K, radial-tangential coefficients)
PINHOLE = [
    (120, 100, [[100.0, 0, 59.5], [0, 98.0, 49.2], [0, 0, 1]], [0, 0, 0, 0]),
    (120, 100, [[100.0, 0, 59.5], [0, 98.0, 49.2], [0, 0, 1]], [-0.12, 0.03, 0.001, -0.002]),
    (161, 97, [[140.0, 0, 80.2], [0, 141.0, 47.9], [0, 0, 1]], [0.2, -0.1, 0.003, 0.001, 0.02]),
    (640, 480, [[500.0, 0, 321.3], [0, 505.0, 238.9], [0, 0, 1]],
     [-0.25, 0.08, 0.0012, -0.0008, -0.01]),
]
# (width, height, K, k1..k4)
FISHEYE = [
    (120, 100, [[100.0, 0, 62.5], [0, 98.0, 47.0], [0, 0, 1]], [0, 0, 0, 0]),
    (120, 100, [[100.0, 0, 62.5], [0, 98.0, 47.0], [0, 0, 1]], [0.05, -0.01, 0.002, -0.0005]),
    (640, 480, [[300.0, 0, 322.0], [0, 301.0, 236.5], [0, 0, 1]], [0.12, -0.04, 0.01, -0.002]),
]


def exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() == 0 and (got != want).sum() == 0, (diff.max(), (got != want).sum())


@pytest.mark.parametrize("case", PINHOLE, ids=["zero", "barrel", "mixed", "vga"])
def test_pinhole_equals_cv2(case):
    w, h, K, dist = case
    K, dist = np.array(K), np.array(dist, float)
    pts = np.random.RandomState(w).rand(64, 2) * [w, h]
    exact(U.undistort_points(pts, K, dist, None, K),
          cv2.undistortPoints(pts[:, None], K, dist, None, K)[:, 0])
    for alpha in (0, 1):
        new_K = cv2.getOptimalNewCameraMatrix(K, dist, (w, h), alpha, (w, h), True)[0]
        exact(U.optimal_new_camera_matrix(K, dist, (w, h), alpha, (w, h), True), new_K)
    m1, m2 = cv2.initUndistortRectifyMap(K, dist, np.eye(3), new_K, (w, h), cv2.CV_32FC1)
    u1, u2 = U.undistort_rectify_map(K, dist, np.eye(3), new_K, (w, h))
    exact(u1, m1)
    exact(u2, m2)


@pytest.mark.parametrize("case", FISHEYE, ids=["zero", "mild", "vga"])
def test_fisheye_equals_cv2(case):
    w, h, K, D = case
    K, D = np.array(K), np.array(D, float)
    new_K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, D, (w, h), np.eye(3),
                                                                    balance=0.0)
    exact(U.fisheye_new_camera_matrix(K, D, (w, h), np.eye(3), balance=0.0), new_K)
    new_K[0, 2], new_K[1, 2] = w / 2.0, h / 2.0
    m1, m2 = cv2.fisheye.initUndistortRectifyMap(K, D, np.eye(3), new_K, (w, h), cv2.CV_32FC1)
    u1, u2 = U.fisheye_undistort_rectify_map(K, D, np.eye(3), new_K, (w, h))
    exact(u1, m1)
    exact(u2, m2)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("border", ["reflect101", "constant"])
@pytest.mark.parametrize("seed", [0, 1])
def test_remap_linear_equals_cv2(channels, border, seed):
    rng = np.random.RandomState(seed)
    H, W = 40, 50
    shape = (H, W) if channels == 1 else (H, W, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    mx = (rng.rand(H, W) * (W + 8) - 4).astype(np.float32)
    my = (rng.rand(H, W) * (H + 8) - 4).astype(np.float32)
    mx[0, :5] = np.arange(5)  # integer positions
    if border == "reflect101":
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT_101)
        got = U.remap_linear(img, mx, my, U.BORDER_REFLECT_101)
    else:
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                         borderValue=(255, 255, 255))
        got = U.remap_linear(img, mx, my, U.BORDER_CONSTANT, 255)
    exact(got, want)


def test_scannetpp_undistort_image_equals_gd3d():
    from gd3d.data import preprocess_scannetpp as J
    from gd3d_torch.data import preprocess_scannetpp as T

    rng = np.random.RandomState(4)
    w, h = 160, 120
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    mask[30:50, 40:70] = 0
    for intr in (["OPENCV_FISHEYE", w, h, 100.0, 101.0, 82.5, 58.5, 0.03, -0.01, 0.002, -0.0005],
                 ["OPENCV", w, h, 100.0, 100.0, 79.3, 60.4, -0.05, 0.01, 0.0005, -0.0004]):
        for got, want in zip(T.undistort_image(intr, rgb, mask), J.undistort_image(intr, rgb, mask)):
            exact(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_nearest_exact_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        h, w = rng.randint(1, 300, 2)
        H, W = rng.randint(1, 700, 2)
        a = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        exact(resize_nearest_exact_cv(a, (W, H)),
              cv2.resize(a, (int(W), int(H)), interpolation=cv2.INTER_NEAREST_EXACT))
    rgb = rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)
    exact(resize_nearest_exact_cv(rgb, (64, 47)),
          cv2.resize(rgb, (64, 47), interpolation=cv2.INTER_NEAREST_EXACT))
