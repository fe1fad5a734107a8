"""Global alignment of pairwise MASt3R predictions (counterpart of
gd3d/align.py: DUSt3R's PointCloudOptimizer).

Per-image log-depth maps, quaternion + signed-log1p poses, log-focals and
principal-point offsets, per-edge sim3 poses and xy/z scale adaptors, and
the confidence-weighted 3D consistency loss
(dust3r/cloud_opt/optimizer.py:16-208, base_opt.py:143-196, commons.py:62-90),
minimized by Adam (betas 0.9, 0.9) under a cosine or linear learning-rate
schedule; `align_pair` is the two-image fast path (pair_viewer.py).

As in gd3d, every image of a scene shares one (H, W), so each per-image and
per-edge quantity is one stacked tensor on the scene's device, and the
initialization is a confidence-weighted Umeyama chain over a spanning tree
of edges (float64 numpy on the host, copied from gd3d so both packages give
the same bits). The optimizer is optax's Adam written out on fp32 tensors:
eps 1e-8 outside the square root, the bias correction at the count after
the increment, the learning rate at the count before it. The loop is a
Python loop of eager steps. Frozen parameters (principal points and pairwise
adaptors by default) take no part in it; frozen rows of a parameter get a
zero gradient, so their moments and updates stay exactly 0 and a pinned
value stays bit-exact.

The random draws of `init=None` come from `normal_draw` (a torch.Generator
seeded with `seed`); gd3d draws with jax.random, whose numbers torch cannot
make, and its tests replace `normal_draw` to feed gd3d's draws in.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gd3d_torch.models.vggt.heads import quat_to_mat  # scalar-last (x, y, z, w)
from gd3d_torch.teachers.mast3r import no_tf32

POSE_LR = 0.01
PW_BREAK = 20.0  # log-scale divisor for adaptors (base_opt.py:88)
FOCAL_BREAK = 20.0  # log-focal scaling (optimizer.py:22)
BASE_SCALE = 0.5  # pairwise scale norm target (base_opt.py:48)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.9, 1e-8


# --------------------------------------------------------------------------
# small math helpers
# --------------------------------------------------------------------------

def signed_log1p(x):
    """numpy-side inverse of signed_expm1 (init-time pose packing)."""
    return np.sign(x) * np.log1p(np.abs(x))


def signed_expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def pose_vec_to_rt(vec: torch.Tensor) -> torch.Tensor:
    """(..., 7) quat(xyzw) + signed-log1p translation -> (..., 4, 4) rigid
    (base_opt.py:150-155; the quaternion normalized like roma's
    RigidUnitQuat.normalize)."""
    q = vec[..., :4]
    q = q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)), min=1e-8)
    R = quat_to_mat(q)
    T = signed_expm1(vec[..., 4:7])
    top = torch.cat([R, T[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=vec.dtype, device=vec.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> scalar-last unit quaternion (host-side init)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w, x, y, z = 0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s
    elif m00 > m11 and m00 > m22:
        s = math.sqrt(1.0 + m00 - m11 - m22) * 2
        w, x, y, z = (m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s
    elif m11 > m22:
        s = math.sqrt(1.0 + m11 - m00 - m22) * 2
        w, x, y, z = (m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s
    else:
        s = math.sqrt(1.0 + m22 - m00 - m11) * 2
        w, x, y, z = (m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s
    return np.asarray([x, y, z, w], np.float64)


def weighted_umeyama(src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    """Closed-form sim3 (s, R, t) minimizing ||s R src + t - dst||^2_w: the
    init-time stand-in for the reference's RANSAC/PnP (init_im_poses.py),
    since pairwise predictions are metric point clouds already."""
    w = w / max(w.sum(), 1e-12)
    mu_s = (w[:, None] * src).sum(0)
    mu_d = (w[:, None] * dst).sum(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = (w[:, None] * xd).T @ xs
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (w * (xs**2).sum(-1)).sum()
    s = float((D * np.diag(S)).sum() / max(var_s, 1e-12))
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def _host(t) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def normal_draw(shape, seed: int, device) -> torch.Tensor:
    """Standard normal fp32 draws from a torch.Generator seeded with `seed`
    (init=None's random log-depths)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device)


# --------------------------------------------------------------------------
# scene container
# --------------------------------------------------------------------------

@dataclass
class Scene:
    """Stacked pairwise observations for one (H, W) geometry, on one device.

    edges[e] = (i, j); pred_i[e] = image i's 3D points in frame i,
    pred_j[e] = image j's 3D points in frame i (dust3r convention,
    optimizer.py:17-20); conf_* are the matching confidence maps."""

    edges: np.ndarray          # (E, 2) int
    pred_i: torch.Tensor       # (E, P, 3) fp32
    pred_j: torch.Tensor       # (E, P, 3)
    conf_i: torch.Tensor       # (E, P)
    conf_j: torch.Tensor       # (E, P)
    hw: Tuple[int, int]
    n_imgs: int
    # per-image (x, y) pixel coordinates of the P sample points; None means
    # the dense H*W grid (sparse_from_scene sets it for anchor subsets)
    pix: Optional[np.ndarray] = None   # (N, P, 2)

    @property
    def device(self) -> torch.device:
        return self.pred_i.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, pred_i=self.pred_i.to(device), pred_j=self.pred_j.to(device),
            conf_i=self.conf_i.to(device), conf_j=self.conf_j.to(device))

    @staticmethod
    def from_pairs(
        edges: Sequence[Tuple[int, int]],
        pred_i: Sequence[np.ndarray],
        pred_j: Sequence[np.ndarray],
        conf_i: Sequence[np.ndarray],
        conf_j: Sequence[np.ndarray],
        device=None,
    ) -> "Scene":
        hw = tuple(pred_i[0].shape[:2])
        for p in list(pred_i) + list(pred_j):
            assert tuple(p.shape[:2]) == hw, (
                "one (H, W) per scene: bucket mixed-geometry scenes before aligning")
        E = len(edges)
        n = int(max(max(e) for e in edges)) + 1

        def flat(xs, c):
            a = np.stack([_host(x).reshape(-1, c) if c > 1 else _host(x).reshape(-1)
                          for x in xs])
            return torch.as_tensor(a.astype(np.float32), device=device)

        return Scene(
            edges=np.asarray(edges, np.int32).reshape(E, 2),
            pred_i=flat(pred_i, 3), pred_j=flat(pred_j, 3),
            conf_i=flat(conf_i, 1), conf_j=flat(conf_j, 1),
            hw=hw, n_imgs=n,
        )


def _pixel_grid(hw: Tuple[int, int], device=None) -> torch.Tensor:
    H, W = hw
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(-1, 2).float()


def _estimate_focal(pred: np.ndarray, hw: Tuple[int, int],
                    pix: Optional[np.ndarray] = None) -> float:
    """Median-ratio focal from a camera-frame point map: the robust-median
    core of dust3r's estimate_focal_knowing_depth (the median of per-pixel
    ratios is a one-step approximation of its Weiszfeld iteration)."""
    H, W = hw
    pts = pred.reshape(-1, 3)
    if pix is None:
        pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    uv = pix - np.asarray([W / 2, H / 2])
    z = pts[:, 2]
    xy = pts[:, :2]
    num = (uv * xy).sum(-1) * z
    den = (xy**2).sum(-1)
    ok = den > 1e-8
    return float(np.median(num[ok] / den[ok]))


def _image_conf(scene: Scene) -> np.ndarray:
    """Per-image confidence = max over every edge observing the image
    (base_opt.py:135-141 semantics), (n, P) fp32 on the host."""
    conf_i, conf_j = _host(scene.conf_i), _host(scene.conf_j)
    im_conf = np.zeros((scene.n_imgs, conf_i.shape[1]), np.float32)
    for e, (i, j) in enumerate(scene.edges):
        im_conf[int(i)] = np.maximum(im_conf[int(i)], conf_i[e])
        im_conf[int(j)] = np.maximum(im_conf[int(j)], conf_j[e])
    return im_conf


# --------------------------------------------------------------------------
# initialization: confidence spanning tree + per-edge Procrustes
# --------------------------------------------------------------------------

def init_from_tree(scene: Scene) -> Dict[str, np.ndarray]:
    """cam2world poses, focals and depth inits from a max-confidence
    spanning tree of edges, chaining closed-form sim3s (float64, host).

    Needs symmetric edge pairs (i, j) and (j, i), as make_pairs gives them
    by default (dust3r/image_pairs.py:26-29)."""
    E = len(scene.edges)
    conf_i, conf_j = _host(scene.conf_i), _host(scene.conf_j)
    pred_i, pred_j = _host(scene.pred_i), _host(scene.pred_j)
    edge_index = {(int(i), int(j)): e for e, (i, j) in enumerate(scene.edges)}
    score = {e: float(conf_i[e].mean() * conf_j[e].mean()) for e in range(E)}

    # per-image depth + focal from its most confident outgoing edge
    n = scene.n_imgs
    best_edge = [-1] * n
    for e, (i, j) in enumerate(scene.edges):
        i = int(i)
        if best_edge[i] < 0 or score[e] > score[best_edge[i]]:
            best_edge[i] = e
    assert all(b >= 0 for b in best_edge), "every image needs an edge as i"
    depth0 = np.stack([pred_i[best_edge[i]][:, 2].clip(1e-3) for i in range(n)])
    pix = scene.pix
    focals0 = np.asarray([
        _estimate_focal(pred_i[best_edge[i]], scene.hw, None if pix is None else pix[i])
        for i in range(n)
    ])

    # relative sim3 per (unordered) pair from the symmetric edge: T maps
    # frame j -> frame i, aligning image j's points seen in frame j (edge
    # (j, i).pred_i) onto frame i (edge (i, j).pred_j)
    cam2world = [None] * n
    cam2world[0] = np.eye(4)
    visited = {0}
    pairs = sorted(((score[e], int(i), int(j), e) for e, (i, j) in enumerate(scene.edges)),
                   reverse=True)
    while len(visited) < n:
        progressed = False
        for _, i, j, e in pairs:
            if (i in visited) == (j in visited):
                continue
            rev = edge_index.get((j, i))
            if rev is None:
                continue
            in_i = pred_j[e]
            in_j = pred_i[rev]
            w = np.minimum(conf_j[e], conf_i[rev])
            s, R, t = weighted_umeyama(in_j, in_i, w)
            T_j2i = np.eye(4)
            T_j2i[:3, :3] = s * R
            T_j2i[:3, 3] = t
            if i in visited:
                cam2world[j] = cam2world[i] @ T_j2i
                visited.add(j)
            else:
                cam2world[i] = cam2world[j] @ np.linalg.inv(T_j2i)
                visited.add(i)
            progressed = True
        if not progressed:
            raise ValueError("edge graph is disconnected or lacks symmetric pairs")

    poses = np.stack(cam2world)
    # chained poses are sim3: renormalize the rotation, fold the scale into
    # the depth (the optimizer's pairwise scales absorb the rest)
    for k in range(n):
        R = poses[k][:3, :3]
        s = np.cbrt(max(np.linalg.det(R), 1e-12))
        poses[k][:3, :3] = R / s
        depth0[k] = depth0[k] * s
    return {"poses": poses, "focals": focals0, "depth": depth0}


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def _init_pw_poses(scene: Scene, init: Dict[str, np.ndarray],
                   norm_pw: bool = True) -> np.ndarray:
    """Per-edge sim3 init: register pred_i onto the initialized world points
    of image i (init_im_poses.py:init_from_pts3d:96-101), then fold the
    pairwise scale normalization back into depths and translations
    (:103-107) so the online norm_pw_scale leaves the init consistent."""
    H, W = scene.hw
    n = scene.n_imgs
    dense = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    pix = scene.pix
    world = []
    for k in range(n):
        d = init["depth"][k].reshape(-1)
        f = init["focals"][k]
        g = dense if pix is None else pix[k]
        rel = np.concatenate([d[:, None] * (g - np.asarray([W / 2, H / 2])) / f, d[:, None]], -1)
        P = init["poses"][k]
        world.append(rel @ P[:3, :3].T + P[:3, 3])

    E = len(scene.edges)
    pw = np.zeros((E, 8), np.float32)
    log_s = np.zeros(E)
    pred_i, conf_i = _host(scene.pred_i), _host(scene.conf_i)
    for e, (i, j) in enumerate(scene.edges):
        s, R, t = weighted_umeyama(pred_i[e], world[int(i)], conf_i[e])
        pw[e, :4] = mat_to_quat(R)
        pw[e, 4:7] = signed_log1p(t / s)
        pw[e, 7] = np.log(max(s, 1e-8))
        log_s[e] = pw[e, 7]

    # the loss renormalizes pw log-scales to mean log(BASE_SCALE): rescale
    # the world (depths + image translations) by the same factor so the
    # registration stays exact after it. With preset poses the normalization
    # is off (optimizer.py:78-82) and the world keeps its given scale.
    if norm_pw:
        s_factor = BASE_SCALE / float(np.exp(log_s.mean()))
        init["depth"] = init["depth"] * s_factor
        init["poses"] = init["poses"].copy()
        init["poses"][:, :3, 3] *= s_factor
    return pw


def _init_params(scene: Scene, init: Optional[Dict[str, np.ndarray]], seed: int = 0,
                 norm_pw: bool = True) -> Dict[str, torch.Tensor]:
    n, (H, W) = scene.n_imgs, scene.hw
    dev = scene.device
    pw_poses = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0, 0], np.float32), (len(scene.edges), 1))
    if init is not None:
        # also rescales init in place when norm_pw
        pw_poses = _init_pw_poses(scene, init, norm_pw)
        depth_log = torch.as_tensor(
            np.log(np.clip(init["depth"], 1e-6, None)).astype(np.float32), device=dev)
        im_poses = np.zeros((n, 7), np.float32)
        for k in range(n):
            # params ARE cam2world (get_im_poses semantics)
            im_poses[k, :4] = mat_to_quat(init["poses"][k][:3, :3])
            im_poses[k, 4:7] = signed_log1p(init["poses"][k][:3, 3])
        focals_log = FOCAL_BREAK * np.log(np.clip(init["focals"], 1.0, None)).astype(np.float32)
    else:
        depth_log = normal_draw((n, scene.pred_i.shape[1]), seed, dev) / 10.0 - 3.0
        im_poses = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (n, 1))
        focals_log = np.full((n,), FOCAL_BREAK * math.log(max(H, W)), np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return {
        "depth_log": depth_log.float(),
        "im_poses": t(im_poses),
        "focals_log": t(focals_log),
        "im_pp": torch.zeros((n, 2), device=dev),
        # per-edge: quat + log1p-trans + log-scale (base_opt.py:90)
        "pw_poses": t(pw_poses),
        "pw_adaptors": torch.zeros((len(scene.edges), 2), device=dev),
    }


def rotate(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ R^T per batch row: R (B, 3, 3), x (B, P, 3) -> (B, P, 3). A
    broadcast product and a sum over 3, not a batched matmul: cuBLAS's fp32
    bmm with an inner dimension of 3 took 5.8 ms a call at (4, 196608, 3) on
    an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py's align phase)."""
    return (R[:, None] * x[..., None, :]).sum(-1)


def _world_points(depth, grid, pp, focals, c2w) -> torch.Tensor:
    """Camera-frame points of every pixel, to world (optimizer.py:203-208):
    depth (N, P), grid (N, P, 2), pp (N, 2), focals (N,), c2w (N, 4, 4)."""
    rel = torch.cat([depth[..., None] * (grid - pp[:, None]) / focals[:, None, None],
                     depth[..., None]], dim=-1)
    return rotate(c2w[:, :3, :3], rel) + c2w[:, None, :3, 3]


def _scene_loss(params, scene: Scene, grid, pp_base, ei, ej, wi, wj,
                dist: str, norm_pw: bool = True) -> torch.Tensor:
    """The PointCloudOptimizer forward (optimizer.py:187-208)."""
    focals = torch.exp(params["focals_log"] / FOCAL_BREAK)  # (N,)
    pp = pp_base + 10.0 * params["im_pp"]                    # (N, 2)
    depth = torch.exp(params["depth_log"])                   # (N, P)
    world = _world_points(depth, grid, pp, focals, pose_vec_to_rt(params["im_poses"]))

    # pairwise sim3 + adaptors (base_opt.py:143-196)
    pw_rt = pose_vec_to_rt(params["pw_poses"][:, :7])        # (E, 4, 4)
    log_scale = params["pw_poses"][:, 7]
    if norm_pw:  # base_opt.py:178-189; off with preset poses
        log_scale = log_scale + (math.log(BASE_SCALE) - torch.mean(log_scale))
    pw_scale = torch.exp(log_scale)
    adapt = torch.cat([params["pw_adaptors"][:, 0:1], params["pw_adaptors"]], dim=-1)
    if norm_pw:  # get_adaptors mean-centers only when norm_pw_scale is on
        adapt = adapt - torch.mean(adapt, dim=1, keepdim=True)
    adapt = torch.exp(adapt / PW_BREAK)                      # (E, 3)

    def edge_align(pred):
        scaled = adapt[:, None, :] * pred                    # (E, P, 3)
        out = rotate(pw_rt[:, :3, :3], scaled)
        return pw_scale[:, None, None] * out + pw_scale[:, None, None] * pw_rt[:, None, :3, 3]

    aligned_i = edge_align(scene.pred_i)
    aligned_j = edge_align(scene.pred_j)

    def d(a, b, w):
        if dist == "l2":
            return torch.sum((a - b) ** 2, -1) * w
        # safe L1: the gradient of sqrt at exactly-zero residuals (a perfect
        # init) is NaN otherwise
        return torch.sqrt(torch.sum((a - b) ** 2, -1) + 1e-12) * w

    P = scene.pred_i.shape[1]
    li = torch.sum(d(world[ei], aligned_i, wi)) / (len(ei) * P)
    lj = torch.sum(d(world[ej], aligned_j, wj)) / (len(ej) * P)
    return li + lj


def lr_schedule(lr: float, lr_min: float, niter: int, schedule: str) -> np.ndarray:
    """The learning rate of each of niter steps, fp32 as optax computes it
    (cosine_decay_schedule(lr, niter, alpha=lr_min / lr) or
    linear_schedule(lr, lr_min, niter)), at the count before the step."""
    f32 = np.float32
    count = np.arange(niter, dtype=f32)
    if schedule == "cosine":
        alpha = lr_min / lr
        c = np.minimum(count, f32(niter))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(niter)))
        return (f32(1 - alpha) * cosine + f32(alpha)) * f32(lr)
    if schedule == "linear":
        frac = f32(1) - np.clip(count, 0, niter) / f32(niter)
        return f32(lr - lr_min) * frac + f32(lr_min)
    raise ValueError(f"bad schedule {schedule!r}")


class Adam:
    """optax.adam(schedule, b1, b2) on a dict of fp32 tensors: the moments
    (1 - b) * g + b * m, the bias correction 1 - b ** count at the count
    after the increment, the update m_hat / (sqrt(v_hat) + eps) scaled by
    the negative learning rate of the count before it."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: np.ndarray,
                 b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS):
        self.lrs, self.b1, self.b2, self.eps = lrs, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        step_size = -float(self.lrs[self.count])
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for k, g in grads.items():
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            params[k] = params[k] + step_size * update


def global_align(
    scene: Scene,
    niter: int = 300,
    lr: float = POSE_LR,
    lr_min: float = 1e-6,
    schedule: str = "cosine",
    dist: str = "l1",
    init: Optional[str] = "tree",
    known_poses: Optional[np.ndarray] = None,
    pose_mask: Optional[np.ndarray] = None,
    known_focals: Optional[np.ndarray] = None,
    focal_mask: Optional[np.ndarray] = None,
    known_pp: Optional[np.ndarray] = None,
    pp_mask: Optional[np.ndarray] = None,
    known_depths: Optional[np.ndarray] = None,
    depth_mask: Optional[np.ndarray] = None,
    optimize_pp: bool = False,
    allow_pw_adaptors: bool = False,
    seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """Run the full alignment on the scene's device; returns poses, focals,
    principal_points, depthmaps, pts3d and the per-step losses as tensors.

    Principal points and pairwise adaptors are frozen by default, as in the
    reference (optimizer.py optimize_pp=False; base_opt.py
    allow_pw_adaptors=False): pass optimize_pp / allow_pw_adaptors to train
    them.

    Partial presets (ModularPointCloudOptimizer,
    dust3r/cloud_opt/modular_optimizer.py:38-68): each known_* array can
    come with a boolean *_mask (N,) (or an index list) selecting the images
    it pins: preset values overwrite the init and their rows are frozen;
    other images keep optimizing. Without a mask a known_* pins every image
    (PointCloudOptimizer.preset_*, optimizer.py:68-102). known_poses are
    cam2world (N, 4, 4); known_focals (N,); known_pp (N, 2) pixels;
    known_depths (N, H, W) (or (N, P) on sparse scenes). Pairwise-scale
    normalization turns off once a pose or depth map is pinned."""
    n = scene.n_imgs

    def as_mask(mask, known):
        if known is None:
            return np.zeros(n, bool)
        if mask is None:
            return np.ones(n, bool)
        m = np.asarray(mask)
        if m.dtype != bool:  # index list
            out = np.zeros(n, bool)
            out[m] = True
            return out
        return m

    pose_mask = as_mask(pose_mask, known_poses)
    focal_mask = as_mask(focal_mask, known_focals)
    pp_mask = as_mask(pp_mask, known_pp)
    depth_mask = as_mask(depth_mask, known_depths)
    lrs = lr_schedule(lr, lr_min, niter, schedule)

    any_preset = any(k is not None for k in (known_poses, known_focals, known_pp, known_depths))
    init_state = None
    if init == "tree" or any_preset:
        init_state = init_from_tree(scene)
    if known_poses is not None:
        init_state["poses"] = np.where(pose_mask[:, None, None],
                                       np.asarray(known_poses, np.float64), init_state["poses"])
    if known_focals is not None:
        init_state["focals"] = np.where(focal_mask, np.asarray(known_focals, np.float64),
                                        init_state["focals"])
    if known_depths is not None:
        kd = np.asarray(known_depths, np.float64).reshape(n, -1)
        if scene.pix is not None and kd.shape[1] != scene.pred_i.shape[1]:
            # dense (N, H, W) depths on a sparse-anchor scene: gather
            W_im = scene.hw[1]
            lin = (scene.pix[..., 1] * W_im + scene.pix[..., 0]).astype(int)
            kd = np.take_along_axis(kd, lin, axis=1)
        init_state["depth"] = np.where(depth_mask[:, None], kd,
                                       init_state["depth"].reshape(n, -1))
    # pw-scale normalization turns off once the scene scale is constrained
    # from outside: any pinned pose or depth map (pinned values stay exact)
    norm_pw = not (pose_mask.any() or depth_mask.any())
    params = _init_params(scene, init_state, seed, norm_pw=norm_pw)
    dev = scene.device
    H, W = scene.hw
    if known_pp is not None:
        pp0 = np.asarray(known_pp, np.float32) - np.asarray([[W / 2, H / 2]], np.float32)
        params["im_pp"] = torch.as_tensor(
            np.where(pp_mask[:, None], pp0 / 10.0, _host(params["im_pp"])).astype(np.float32),
            device=dev)

    if scene.pix is None:
        grid = _pixel_grid(scene.hw, dev)[None].expand(n, H * W, 2)
    else:
        grid = torch.as_tensor(np.asarray(scene.pix, np.float32), device=dev)
    pp_base = torch.tensor([[W / 2, H / 2]], dtype=torch.float32, device=dev).repeat(n, 1)
    ei = torch.as_tensor(scene.edges[:, 0].astype(np.int64), device=dev)
    ej = torch.as_tensor(scene.edges[:, 1].astype(np.int64), device=dev)
    # log confidence weights (commons.py:49-50, cf='log' default)
    wi = torch.log(torch.clamp(scene.conf_i, min=1.0 + 1e-6))
    wj = torch.log(torch.clamp(scene.conf_j, min=1.0 + 1e-6))

    # the rows a mask pins: their gradient is 0 (stop_gradient in gd3d)
    row_masks = {"im_poses": pose_mask, "focals_log": focal_mask, "depth_log": depth_mask,
                 "im_pp": pp_mask}
    trained = ["depth_log", "im_poses", "focals_log", "pw_poses"]
    if optimize_pp:
        trained.append("im_pp")
    if allow_pw_adaptors:
        trained.append("pw_adaptors")
    masks = {k: torch.as_tensor(m, device=dev).reshape((-1,) + (1,) * (params[k].ndim - 1))
             for k, m in row_masks.items() if k in trained and m.any()}

    def loss_fn(p):
        p = dict(p)
        for k, m in masks.items():
            p[k] = torch.where(m, p[k].detach(), p[k])
        return _scene_loss(p, scene, grid, pp_base, ei, ej, wi, wj, dist, norm_pw=norm_pw)

    adam = Adam({k: params[k] for k in trained}, lrs)
    losses = []
    with no_tf32():
        for _ in range(niter):
            leaves = {k: params[k].detach().requires_grad_(True) for k in trained}
            loss = loss_fn({**params, **leaves})
            grads = torch.autograd.grad(loss, [leaves[k] for k in trained])
            losses.append(loss.detach())
            adam.step(params, dict(zip(trained, grads)))

        with torch.no_grad():
            focals = torch.exp(params["focals_log"] / FOCAL_BREAK)
            pp = pp_base + 10.0 * params["im_pp"]
            depth_flat = torch.exp(params["depth_log"])  # (N, P)
            c2w = pose_vec_to_rt(params["im_poses"])
            world = _world_points(depth_flat, grid, pp, focals, c2w)
    dense = scene.pix is None
    return {
        "poses": c2w,
        "focals": focals,
        "principal_points": pp,
        # dense scenes reshape to (N, H, W[, 3]); sparse keep (N, P[, 3])
        "depthmaps": depth_flat.reshape(n, H, W) if dense else depth_flat,
        "pts3d": world.reshape(n, H, W, 3) if dense else world,
        "losses": torch.stack(losses) if losses else torch.zeros(0, device=dev),
    }


def sparse_from_scene(scene: Scene, k: int = 1024) -> Scene:
    """Sparse-anchor view of a dense scene: keep k confident pixels per image
    and optimize only those (the compact counterpart of MASt3R's sparse
    global alignment, mast3r/cloud_opt/sparse_ga.py).

    Per-image confidence is the max over every edge that observes the image;
    the anchors are the top-confidence pixel of each cell of a ~sqrt(k)-wide
    grid (a global top-k clusters on textured regions), trimmed to k by
    confidence and filled by confidence where fewer cells hold one. Every
    per-edge map is gathered at its owning image's anchors (pred_i at image
    i's, pred_j at image j's). The choice is gd3d's numpy, ties in numpy's
    argsort order."""
    assert scene.pix is None, "scene is already sparse"
    H, W = scene.hw
    n = scene.n_imgs
    im_conf = _image_conf(scene)
    k = min(k, H * W)

    G = int(math.ceil(math.sqrt(k)))
    ys, xs = np.divmod(np.arange(H * W), W)
    cell = (ys * G // H) * G + (xs * G // W)  # (HW,) in [0, G*G)
    anchors = np.zeros((n, k), np.int64)
    for im in range(n):
        order = np.argsort(-im_conf[im])  # best first
        # the first pixel of each cell in that order
        cells, first_at = np.unique(cell[order], return_index=True)
        first = np.full(G * G, -1, np.int64)
        first[cells] = order[first_at]
        cand = first[first >= 0]
        cand = cand[np.argsort(-im_conf[im][cand])][:k]
        if len(cand) < k:  # fewer non-empty cells than k: fill by top conf
            extra = order[~np.isin(order, cand)]
            cand = np.concatenate([cand, extra[: k - len(cand)]])
        anchors[im] = cand

    dev = scene.device
    idx = torch.as_tensor(anchors, device=dev)
    ai = idx[torch.as_tensor(scene.edges[:, 0].astype(np.int64), device=dev)]  # (E, k)
    aj = idx[torch.as_tensor(scene.edges[:, 1].astype(np.int64), device=dev)]
    pix = np.stack([anchors % W, anchors // W], -1).astype(np.float32)
    return Scene(
        edges=scene.edges,
        pred_i=torch.gather(scene.pred_i, 1, ai[..., None].expand(-1, -1, 3)),
        pred_j=torch.gather(scene.pred_j, 1, aj[..., None].expand(-1, -1, 3)),
        conf_i=torch.gather(scene.conf_i, 1, ai),
        conf_j=torch.gather(scene.conf_j, 1, aj),
        hw=scene.hw, n_imgs=n, pix=pix,
    )


def scene_from_mast3r(
    teacher,
    images: torch.Tensor,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    temperature: float = 1.0,
    dtype: Optional[str] = None,
    return_desc: bool = False,
):
    """Build a Scene by running the frozen MASt3R teacher over image pairs.

    images (N, H, W, 3) in [-1, 1] on the teacher's device (W >= H). pairs
    defaults to the complete symmetric graph. One batched extract_features
    call covers all E ordered pairs: edge (i, j) takes pts3d_1 (image i in
    frame i) and pts3d_2_from_1 (image j in frame i), the dust3r pred_i /
    pred_j convention. The call is not chunked: alignment reads only the
    per-pair point, confidence and descriptor maps.

    With return_desc, also returns the per-edge descriptor grids (desc_i,
    desc_j), (E, H, W, D) tensors, for reciprocal matching (the COLMAP
    database needs discrete correspondences)."""
    n = images.shape[0]
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    ii = torch.as_tensor([p[0] for p in pairs], device=images.device)
    jj = torch.as_tensor([p[1] for p in pairs], device=images.device)
    feats = teacher.extract_features(images[ii], images[jj], temperature, dtype=dtype)
    E = len(pairs)
    scene = Scene(
        edges=np.asarray(pairs, np.int32).reshape(E, 2),
        pred_i=feats["pts3d_1"].reshape(E, -1, 3),
        pred_j=feats["pts3d_2_from_1"].reshape(E, -1, 3),
        conf_i=feats["conf_1"].reshape(E, -1),
        conf_j=feats["conf_2"].reshape(E, -1),
        hw=tuple(images.shape[1:3]), n_imgs=n,
    )
    if return_desc:
        return scene, feats["desc_1"], feats["desc_2"]
    return scene


def align_pair(scene: Scene) -> Dict[str, np.ndarray]:
    """Two-image fast path, PairViewer (pair_viewer.py:20-110): no
    optimization, poses from the most confident direction's Procrustes."""
    assert scene.n_imgs == 2
    assert scene.pix is None, (
        "align_pair returns dense (H, W) depthmaps: use global_align for sparse scenes")
    init = init_from_tree(scene)
    H, W = scene.hw
    return {
        "poses": init["poses"],
        "focals": init["focals"],
        "depthmaps": np.asarray(init["depth"]).reshape(2, H, W),
    }
