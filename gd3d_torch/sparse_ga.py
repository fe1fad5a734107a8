"""MASt3R's two-stage sparse global alignment (counterpart of
gd3d/sparse_ga.py; mast3r/cloud_opt/sparse_ga.py).

  1. symmetric pair inference of the frozen teacher and reciprocal
     correspondences (`build_scene_from_mast3r`),
  2. per-image canonical pointmaps ('avg-angle' relative depth) and a robust
     focal estimate (`canonical_view`),
  3. an anchor grid: every correspondence pixel hangs off its block's anchor
     by a depth ratio (`anchor_depth_offsets`),
  4. a minimum spanning tree over the pairs' match counts, which chains the
     cameras as relative poses, with the z_camera / global-scaling
     reparameterization (`_make_K_cam_depth`),
  5. the coarse stage: Adam (betas 0.9, 0.9), cosine lr 0.2 -> 0, the 3D
     matching loss gamma(1.1), poses and log-sizes only,
  6. the fine stage: lr 0.02, the 2D reprojection loss gamma(0.4), focals,
     principal points and anchor depths unfrozen; both stages add the
     DUSt3R-regression fallback (weight 0.01) on pairs whose matching
     confidence stays under matching_conf_thr.

As in gd3d, the correspondences are fixed-size padded (E, G) arrays with
validity masks. The scene is built on the host (numpy, the canonical views
in torch on the CPU); the optimizer runs on the device it is given, as a
Python loop of eager steps, with `align.Adam` (optax's Adam written out)
and a learning rate equal to optax.cosine_decay_schedule(lr, niter) read at
the count before the increment. Only the stage's trained keys step, so the
frozen ones keep their bits. The MST and the BFS ranks are gd3d's numpy and
scipy code, so both packages chain the same cameras. Small (.., 3) x (3, 3)
products are broadcast multiplies and sums (align.rotate's reason), and
TF32 stays off around the loop.

Not ported, as in gd3d: lora_depth, exp_depth and the depth modes other
than 'add'.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gd3d_torch.align import Adam, _estimate_focal, _host, lr_schedule
from gd3d_torch.models.vggt.heads import quat_to_mat  # scalar-last (x, y, z, w)
from gd3d_torch.teachers.mast3r import no_tf32

ADAM_B1 = ADAM_B2 = 0.9  # the reference's betas (sparse_ga.py:396)


# --------------------------------------------------------------- losses
def l1_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x - y| over the last axis; the double where keeps the gradient
    finite at coincident points."""
    d2 = torch.sum(torch.square(x - y), dim=-1)
    return torch.where(d2 > 0, torch.sqrt(torch.clamp(d2, min=1e-24)), torch.zeros_like(d2))


def gamma_loss(gamma: float, mul: float = 1.0, offset: Optional[float] = None,
               clip: float = np.inf):
    """cloud_opt/utils/losses.py:19-28: (mul*|x-y| + o)^g - o^g with the
    unit-slope offset o = (1/g)^(1/(g-1))."""
    if offset is None:
        if gamma == 1:
            return l1_dist
        offset = (1 / gamma) ** (1 / (gamma - 1))

    def loss_func(x, y):
        return (mul * torch.clamp(l1_dist(x, y), max=clip) + offset) ** gamma - offset ** gamma
    return loss_func


def cosine_schedule(alpha, lr_base, lr_end=0.0):
    return lr_end + (lr_base - lr_end) * (1 + np.cos(alpha * np.pi)) / 2


def linear_schedule(alpha, lr_base, lr_end=0.0):
    return (1 - alpha) * lr_base + alpha * lr_end


# ------------------------------------------------------ canonical views
def _pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*r*r, H/r, W/r), F.pixel_unshuffle's layout."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, C * r * r, H // r, W // r)


def _pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    B, C, H, W = x.shape
    x = x.reshape(B, C // (r * r), r, r, H, W)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(B, C // (r * r), H * r, W * r)


def canonical_view(ptmaps11: torch.Tensor, confs11: torch.Tensor, subsample: int,
                   mode: str = "avg-angle"):
    """Canonical pointmap of one image from its n pairwise predictions
    (sparse_ga.py:699-737). ptmaps11 (n, H, W, 3), confs11 (n, H, W).
    Returns (canon (H, W, 3), canon2 (H, W) relative depth, cconf (H, W))."""
    confs = confs11[..., None] - 0.999
    canon = (confs * ptmaps11).sum(0) / confs.sum(0)

    canon_depth = ptmaps11[..., 2][:, None]  # (n, 1, H, W)
    s0 = subsample // 2
    center_depth = canon_depth[:, :, s0::subsample, s0::subsample]
    center_depth = torch.clamp(center_depth, min=float(np.finfo(np.float32).eps))

    stacked_depth = _pixel_unshuffle(canon_depth, subsample)
    stacked_confs = _pixel_unshuffle(confs[:, None, :, :, 0], subsample)

    if mode == "avg-reldepth":
        rel = stacked_depth / center_depth
        stacked_canon = (stacked_confs * rel).sum(0) / stacked_confs.sum(0)
        canon2 = _pixel_shuffle(stacked_canon[None], subsample)[0, 0]
    elif mode == "avg-angle":
        xy = ptmaps11[..., 0:2].permute(0, 3, 1, 2)  # (n, 2, H, W)
        stacked_xy = _pixel_unshuffle(xy, subsample)
        n, _, H2, W2 = stacked_xy.shape
        radius = torch.linalg.norm(
            stacked_xy.reshape(n, 2, -1, H2, W2)
            - xy[:, :, None, s0::subsample, s0::subsample], dim=1)
        radius = torch.clamp(radius, min=1e-8)
        angle = torch.arctan((stacked_depth - center_depth) / radius)
        avg_angle = (stacked_confs * angle).sum(0) / stacked_confs.sum(0)
        depth2 = radius.mean(0) * torch.tan(avg_angle)
        canon2 = _pixel_shuffle(
            (1 + depth2 / canon[s0::subsample, s0::subsample, 2])[None], subsample)[0, 0]
    else:
        raise ValueError(f"bad {mode=}")

    cconf = ((confs ** 2).sum(0) / confs.sum(0))[..., 0]
    return canon, canon2, cconf


def anchor_depth_offsets(canon2: np.ndarray, pix_xy: np.ndarray, subsample: int):
    """Attach pixels to their block anchor (sparse_ga.py:740-768).
    pix_xy (M, 2) int pixel coords -> (core flat idx (M,), depth-ratio
    offsets (M,)) on the (H/sub, W/sub) anchor grid."""
    H1, W1 = canon2.shape
    W2 = int(math.ceil((W1 - subsample // 2) / subsample))
    px, py = np.asarray(pix_xy, np.int64).T
    core_idx = (py // subsample) * W2 + (px // subsample)
    s0 = subsample // 2
    core_depth = np.asarray(canon2)[s0::subsample, s0::subsample].reshape(-1)
    ref_z = core_depth[core_idx]
    pts_z = np.asarray(canon2)[py, px]
    return core_idx, pts_z / ref_z


def compute_min_spanning_tree(scores: np.ndarray):
    """MST over pairwise scores, rooted at the most central node
    (sparse_ga.py:991-1010: double-BFS midpoint), edges parent->child in
    BFS order. gd3d's numpy and scipy, so the tree is the same."""
    from scipy import sparse as sp

    g = sp.dok_array(scores.shape)
    for i, j in zip(*np.nonzero(scores)):
        g[i, j] = -float(scores[i, j])
    msp = sp.csgraph.minimum_spanning_tree(g)

    def bfs_ranks(start):
        # ranks[node] = BFS visitation index (sparse_ga.py:984-988), not hop depth
        order, _ = sp.csgraph.breadth_first_order(msp, start, directed=False)
        ranks = np.arange(len(order))
        ranks[order] = ranks.copy()
        return ranks

    r1 = bfs_ranks(0)
    r2 = bfs_ranks(int(r1.argmax()))
    r1 = bfs_ranks(int(r2.argmax()))
    root = int(np.minimum(r1, r2).argmax())
    order, preds = sp.csgraph.breadth_first_order(msp, root, directed=False)
    edges = [(int(preds[i]), int(i)) for i in order[1:]]
    return root, edges


# ----------------------------------------------------------- scene data
@dataclasses.dataclass(frozen=True)
class SparseScene:
    """The padded sparse-GA problem on the host (A = anchor-grid size, E
    edges, G correspondence slots), gd3d's fields and dtypes."""

    hw: Tuple[int, int]
    n_imgs: int
    subsample: int
    pps: np.ndarray            # (N, 2) principal points, px
    base_focals: np.ndarray    # (N,)
    core_depth0: np.ndarray    # (N, A) canonical depth at anchors
    canon2: np.ndarray         # (N, H, W) relative-depth maps (densify)
    e_i: np.ndarray            # (E,)
    e_j: np.ndarray            # (E,)
    pix_i: np.ndarray          # (E, G, 2)
    pix_j: np.ndarray          # (E, G, 2)
    conf: np.ndarray           # (E, G)
    valid: np.ndarray          # (E, G) bool
    aidx_i: np.ndarray         # (E, G) anchor index in image e_i
    aidx_j: np.ndarray         # (E, G)
    off_i: np.ndarray          # (E, G) depth-ratio offsets
    off_j: np.ndarray          # (E, G)
    d_pts: np.ndarray          # (E, G, 3) img-j points in img-i's frame
    d_conf: np.ndarray         # (E, G) their confidence
    matching_ok: np.ndarray    # (E,) bool: conf.max() > matching_conf_thr
    mst_root: int
    mst_edges: Tuple[Tuple[int, int], ...]

    @property
    def grid_hw(self) -> Tuple[int, int]:
        H, W = self.hw
        s = self.subsample
        return (int(math.ceil((H - s // 2) / s)), int(math.ceil((W - s // 2) / s)))


def build_scene(hw, ptmaps, confs, pts_in_other, confs_other, corres, subsample: int = 8,
                matching_conf_thr: float = 5.0, mode: str = "avg-angle") -> SparseScene:
    """The teacher-free constructor, gd3d's build_scene.

    ptmaps[i]: list of (H, W, 3) predictions of image i in its own frame
      (one per pair observing i); confs[i]: matching (H, W) conf maps.
    pts_in_other[(i, j)]: (H, W, 3) image j's points in image i's frame,
      with confs_other[(i, j)]: the DUSt3R-regression fallback target.
    corres[(i, j)]: (xy_i (M, 2), xy_j (M, 2), conf (M,)) reciprocal
      correspondences of the pair.
    Arrays are numpy (or host tensors)."""
    H, W = hw
    n = len(ptmaps)
    pairs = sorted(corres.keys())
    E = len(pairs)
    G = max(len(corres[p][2]) for p in pairs)

    canon = np.zeros((n, H, W, 3), np.float32)
    canon2 = np.zeros((n, H, W), np.float32)
    s0 = subsample // 2
    core_depth0 = []
    base_focals = np.zeros(n, np.float32)
    pps = np.tile(np.float32([W / 2, H / 2]), (n, 1))
    for i in range(n):
        c, c2, _ = canonical_view(
            torch.from_numpy(np.stack([_host(p) for p in ptmaps[i]]).astype(np.float32)),
            torch.from_numpy(np.stack([_host(p) for p in confs[i]]).astype(np.float32)),
            subsample, mode)
        canon[i] = c.numpy()
        canon2[i] = c2.numpy()
        # the clamps bite only on degenerate input (an untrained teacher's
        # negative z), as in gd3d: the focal at the optimizer's own floor,
        # the anchor depths at a tiny positive value
        diag = float(np.hypot(H, W))
        base_focals[i] = np.clip(_estimate_focal(canon[i], (H, W)), 0.25 * diag, 10.0 * diag)
        core_depth0.append(np.clip(canon[i, s0::subsample, s0::subsample, 2].reshape(-1),
                                   1e-6, None))
    core_depth0 = np.stack(core_depth0)

    e_i = np.array([p[0] for p in pairs], np.int32)
    e_j = np.array([p[1] for p in pairs], np.int32)
    pix_i = np.zeros((E, G, 2), np.float32)
    pix_j = np.zeros((E, G, 2), np.float32)
    conf = np.zeros((E, G), np.float32)
    valid = np.zeros((E, G), bool)
    aidx_i = np.zeros((E, G), np.int64)
    aidx_j = np.zeros((E, G), np.int64)
    off_i = np.ones((E, G), np.float32)
    off_j = np.ones((E, G), np.float32)
    d_pts = np.zeros((E, G, 3), np.float32)
    d_conf = np.zeros((E, G), np.float32)
    scores = np.zeros((n, n), np.float32)

    for e, (i, j) in enumerate(pairs):
        xy_i, xy_j, cf = (_host(a) for a in corres[(i, j)])
        m = len(cf)
        pix_i[e, :m] = xy_i
        pix_j[e, :m] = xy_j
        conf[e, :m] = cf
        valid[e, :m] = True
        aidx_i[e, :m], off_i[e, :m] = anchor_depth_offsets(canon2[i], xy_i, subsample)
        aidx_j[e, :m], off_j[e, :m] = anchor_depth_offsets(canon2[j], xy_j, subsample)
        # the fallback data: image j's points in i's frame at j's anchors
        pred_ji = _host(pts_in_other[(i, j)])
        conf_ji = _host(confs_other[(i, j)])
        grid_pts = pred_ji[s0::subsample, s0::subsample].reshape(-1, 3)
        grid_cf = conf_ji[s0::subsample, s0::subsample].reshape(-1)
        d_pts[e, :m] = grid_pts[aidx_j[e, :m]]
        d_conf[e, :m] = grid_cf[aidx_j[e, :m]]
        scores[i, j] = scores[j, i] = m  # matching_score[2] (:545)

    matching_ok = np.array([conf[e][valid[e]].max(initial=0.0) > matching_conf_thr
                            for e in range(E)])
    root, edges = compute_min_spanning_tree(scores)
    return SparseScene(
        hw=tuple(hw), n_imgs=n, subsample=subsample, pps=pps, base_focals=base_focals,
        core_depth0=core_depth0, canon2=canon2, e_i=e_i, e_j=e_j, pix_i=pix_i, pix_j=pix_j,
        conf=conf, valid=valid, aidx_i=aidx_i, aidx_j=aidx_j, off_i=off_i, off_j=off_j,
        d_pts=d_pts, d_conf=d_conf, matching_ok=matching_ok, mst_root=root,
        mst_edges=tuple(edges))


def build_scene_from_mast3r(teacher, images: torch.Tensor,
                            pairs: Optional[Sequence[Tuple[int, int]]] = None,
                            subsample: int = 8, matching_conf_thr: float = 5.0,
                            temperature: float = 1.0, dtype: Optional[str] = None,
                            max_corres: int = 1024, pair_chunk: int = 8) -> SparseScene:
    """The frozen teacher's entry: symmetric inference over every unordered
    pair (forward_mast3r :524-553) and reciprocal-NN correspondences, as
    gd3d builds them. images (N, H, W, 3) in [-1, 1] on the teacher's
    device.

    Pairs go through the teacher `pair_chunk` at a time (the last chunk as
    it comes: nothing is compiled here, so it needs no padding). A
    correspondence's confidence is sqrt(c1 * c2) of the two matching
    confidence maps at its pixels; at most max_corres of them a pair."""
    from gd3d_torch.distill.keypoints import filter_and_match_keypoints

    n = images.shape[0]
    H, W = int(images.shape[1]), int(images.shape[2])
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    E = len(pairs)
    chunk = max(1, min(pair_chunk, E))
    dev = images.device
    ptmaps: List[List[np.ndarray]] = [[] for _ in range(n)]
    confs: List[List[np.ndarray]] = [[] for _ in range(n)]
    pts_in_other: Dict[Tuple[int, int], np.ndarray] = {}
    confs_other: Dict[Tuple[int, int], np.ndarray] = {}
    corres = {}
    for c0 in range(0, E, chunk):
        sel = pairs[c0:c0 + chunk]
        ii = torch.as_tensor([p[0] for p in sel], device=dev)
        jj = torch.as_tensor([p[1] for p in sel], device=dev)
        f = teacher.extract_features(images[ii], images[jj], temperature, dtype=dtype)
        host = {k: _host(f[k]) for k in ("pts3d_1", "pts3d_2", "pts3d_2_from_1", "conf_1",
                                          "conf_2")}
        for e, (i, j) in enumerate(sel):
            c1, c2 = host["conf_1"][e], host["conf_2"][e]
            ptmaps[i].append(host["pts3d_1"][e])
            confs[i].append(c1)
            ptmaps[j].append(host["pts3d_2"][e])
            confs[j].append(c2)
            # X21: j's points in i's frame (the fallback target); C22 stands
            # in for its confidence map, as in gd3d
            pts_in_other[(i, j)] = host["pts3d_2_from_1"][e]
            confs_other[(i, j)] = c2
            kp1, kp2, valid = filter_and_match_keypoints(
                {"desc_1": f["desc_1"][e], "desc_2": f["desc_2"][e],
                 "conf_1": f["conf_1"][e], "conf_2": f["conf_2"][e]},
                H, W, subsample=subsample, border=0, min_conf_percent=0.0)
            v = _host(valid)
            kp1 = _host(kp1)[v][:max_corres]
            kp2 = _host(kp2)[v][:max_corres]
            x1, y1 = kp1[:, 0].astype(int), kp1[:, 1].astype(int)
            x2, y2 = kp2[:, 0].astype(int), kp2[:, 1].astype(int)
            corres[(i, j)] = (kp1, kp2, np.sqrt(c1[y1, x1] * c2[y2, x2]))
        del f
    return build_scene((H, W), ptmaps, confs, pts_in_other, confs_other, corres, subsample,
                       matching_conf_thr)


# -------------------------------------------------------- the optimizer
class _SceneTensors:
    """A SparseScene's arrays as tensors on the optimizer's device."""

    def __init__(self, scene: SparseScene, device):
        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.scene = scene
        self.base = t(scene.base_focals)
        self.e_i, self.e_j = t(scene.e_i, torch.int64), t(scene.e_j, torch.int64)
        self.pix_i, self.pix_j = t(scene.pix_i), t(scene.pix_j)
        self.aidx_i, self.aidx_j = t(scene.aidx_i), t(scene.aidx_j)
        self.off_i, self.off_j = t(scene.off_i), t(scene.off_j)
        self.conf, self.valid = t(scene.conf), t(scene.valid)
        self.matching_ok = t(scene.matching_ok)
        self.d_pts, self.d_conf = t(scene.d_pts), t(scene.d_conf)
        self.imsizes = torch.tensor([scene.hw[1], scene.hw[0]], dtype=torch.float32,
                                    device=device)


def _rotate(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) applied to x (..., 3): a broadcast product and a sum
    over 3 (see align.rotate)."""
    return (R * x[..., None, :]).sum(-1)


def _make_K_cam_depth(params, st: _SceneTensors, median_depths, min_focals, max_focals,
                      with_extr: bool = True):
    """sparse_scene_optimizer's make_K_cam_depth (:236-283): intrinsics, the
    kinematic-chain cam2w with the z_camera reparameterization, and the
    'add'-mode anchor depthmaps under the global scaling."""
    scene = st.scene
    N = scene.n_imgs
    dev = params["log_focals"].device
    focals = torch.clamp(torch.exp(params["log_focals"]), min=min_focals, max=max_focals)
    zero, one = torch.zeros_like(focals), torch.ones_like(focals)
    pp = params["pps"] * st.imsizes  # (N, 2)
    K = torch.stack([focals, zero, pp[:, 0], zero, focals, pp[:, 1], zero, zero, one],
                    -1).reshape(N, 3, 3)
    if not with_extr:
        return K

    sizes = torch.exp(params["log_sizes"])
    global_scaling = 1.0 / sizes.min()
    z_cameras = sizes * median_depths * focals / st.base

    q = params["quats"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(N, 1, 4)
    rel = torch.cat([torch.cat([quat_to_mat(q), params["trans"][:, :, None]], 2), bottom], 1)

    # the kinematic chain along the (static) MST
    cams: List[Optional[torch.Tensor]] = [None] * N
    cams[scene.mst_root] = rel[scene.mst_root]
    for i, j in scene.mst_edges:
        cams[j] = cams[i] @ rel[j]
    tmp = torch.stack(cams)

    trans_offset = z_cameras[:, None] * torch.cat(
        [st.imsizes / focals[:, None] * (0.5 - params["pps"]), torch.ones((N, 1), device=dev)],
        dim=-1)
    new_trans = global_scaling * (tmp[:, :3, 3] - _rotate(tmp[:, :3, :3], trans_offset))
    cam2w = torch.cat([torch.cat([tmp[:, :3, :3], new_trans[:, :, None]], 2), bottom], 1)
    w2cam = torch.linalg.inv(cam2w)

    # depth_mode='add' (:262-270)
    depth = (z_cameras[:, None] + (params["core_depth"] - 1.0)
             * (median_depths * sizes)[:, None]) * global_scaling
    return K, (w2cam, cam2w), depth, focals


def _corres_pts3d(st: _SceneTensors, K, cam2w, depth, focals):
    """3D points of every (edge, slot) correspondence on both sides
    (make_pts3d :478-506 incl. the focal compensation of the offsets)."""
    def side(im, pix, aidx, off):
        offc = 1.0 + (off - 1.0) * (st.base[im] / focals[im])[:, None]
        z = depth[im[:, None], aidx] * offc  # (E, G)
        Ke = K[im]
        fx, fy = Ke[:, 0, 0][:, None], Ke[:, 1, 1][:, None]
        cx, cy = Ke[:, 0, 2][:, None], Ke[:, 1, 2][:, None]
        pts = torch.stack([(pix[..., 0] - cx) / fx * z, (pix[..., 1] - cy) / fy * z, z], -1)
        c2w = cam2w[im][:, None]
        return _rotate(c2w[..., :3, :3], pts) + c2w[..., :3, 3]

    return (side(st.e_i, st.pix_i, st.aidx_i, st.off_i),
            side(st.e_j, st.pix_j, st.aidx_j, st.off_j))


def _losses(params, st: _SceneTensors, median_depths, min_focals, max_focals, stage: str,
            gamma3d, gamma2d, gammad, loss_dust3r_w):
    K, (w2cam, cam2w), depth, focals = _make_K_cam_depth(
        params, st, median_depths, min_focals, max_focals)
    pts_i, pts_j = _corres_pts3d(st, K, cam2w, depth, focals)

    ok3d = (st.valid & st.matching_ok[:, None]).float()
    w = st.conf * ok3d
    if stage == "coarse":
        # loss_3d (:345-372): conf-weighted 3D distance of each
        # correspondence's two sides
        main = torch.sum(w * gamma3d(pts_i, pts_j)) / torch.clamp(torch.sum(w), min=1e-8)
    else:
        # loss_2d (:374-392): conf-weighted reprojection error, both ways
        def reproj(im, pts):
            # reproj2d (:976-981): z floor 1e-3, uv clip [-1000, 2000]
            P = (K[im][:, :, :, None] * w2cam[im][:, None, :3, :]).sum(2)  # (E, 3, 4)
            h = _rotate(P[:, None, :, :3], pts) + P[:, None, :, 3]
            uv = h[..., :2] / torch.clamp(h[..., 2:], min=1e-3)
            return torch.clamp(uv, min=-1000.0, max=2000.0)

        err_i = gamma2d(st.pix_i, reproj(st.e_i, pts_j))
        err_j = gamma2d(st.pix_j, reproj(st.e_j, pts_i))
        main = torch.sum(w * (err_i + err_j)) / torch.clamp(torch.sum(w) * 2.0, min=1e-8)

    # DUSt3R fallback on low-matching pairs (:305-325): image j's sparse
    # points against its prediction from i's frame, brought to the world by
    # cam2w[i] (roles exchanged against the reference, as in gd3d)
    bad = (st.valid & ~st.matching_ok[:, None]).float()
    dw = st.d_conf * bad
    c2w = cam2w[st.e_i][:, None]
    tgt = _rotate(c2w[..., :3, :3], st.d_pts) + c2w[..., :3, 3]
    dnum = torch.sum(dw * gammad(pts_j, tgt))
    dden = torch.sum(dw)
    loss_d = torch.where(dden > 0, dnum / torch.clamp(dden, min=1e-8), torch.zeros_like(dden))
    return main + loss_dust3r_w * loss_d


def _sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def sparse_scene_optimizer(
    scene: SparseScene,
    lr1: float = 0.2, niter1: int = 500, gamma1: float = 1.1,
    lr2: float = 0.02, niter2: int = 500, gamma2: float = 0.4,
    gammad: float = 1.1,
    opt_pp: bool = True, opt_depth: bool = True,
    loss_dust3r_w: float = 0.01,
    device="cuda",
) -> Dict[str, object]:
    """The two stages (:433-453) on `device`. Returns {"coarse", "fine"}
    snapshots (host arrays: intrinsics, cam2w, anchor depthmaps, the
    per-correspondence sparse 3D points; fine None when niter2 is 0) as
    gd3d does, plus "losses" (each stage's per-step losses, host arrays)
    and "seconds" (each stage's wall time, the device synchronised)."""
    N = scene.n_imgs
    st = _SceneTensors(scene, device)
    core0 = torch.as_tensor(scene.core_depth0, device=device)
    # torch's .median() is the lower middle element on even counts (the
    # anchor grid almost always is): the sort's (A - 1) // 2-th, not a mean
    A = core0.shape[1]
    median_depths = torch.sort(core0, dim=1).values[:, (A - 1) // 2]
    imsizes = np.float32([scene.hw[1], scene.hw[0]])
    diag = float(np.linalg.norm(imsizes))
    min_focals, max_focals = 0.25 * diag, 10.0 * diag

    params = {
        "quats": torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device).repeat(N, 1),
        "trans": torch.zeros((N, 3), device=device),
        "log_sizes": torch.zeros((N,), device=device),
        "pps": torch.as_tensor(scene.pps / imsizes, device=device),  # normalized
        "log_focals": torch.log(torch.as_tensor(scene.base_focals, device=device)),
        "core_depth": core0 / median_depths[:, None],
    }
    g3, g2, gd = gamma_loss(gamma1), gamma_loss(gamma2), gamma_loss(gammad)

    def run_stage(stage, lr_base, niter, train_keys):
        train_keys = [k for k in params if k in train_keys]
        adam = Adam({k: params[k] for k in train_keys},
                    lr_schedule(lr_base, 0.0, max(niter, 1), "cosine"), ADAM_B1, ADAM_B2)
        losses = []
        for _ in range(niter):
            leaves = {k: params[k].detach().requires_grad_(True) for k in train_keys}
            loss = _losses({**params, **leaves}, st, median_depths, min_focals, max_focals,
                           stage, g3, g2, gd, loss_dust3r_w)
            grads = torch.autograd.grad(loss, [leaves[k] for k in train_keys])
            losses.append(loss.detach())
            adam.step(params, dict(zip(train_keys, grads)))
            # keep the pose well optimizable (:416-417)
            params["quats"] = params["quats"] / torch.linalg.norm(
                params["quats"], dim=-1, keepdim=True)
        return _host(torch.stack(losses)) if losses else np.zeros(0, np.float32)

    stage1_keys = {"quats", "trans", "log_sizes"}
    stage2_keys = set(stage1_keys) | {"log_focals"}
    if opt_pp:
        stage2_keys.add("pps")
    if opt_depth:
        stage2_keys.add("core_depth")

    @torch.no_grad()
    def snapshot():
        K, (w2cam, cam2w), depth, focals = _make_K_cam_depth(
            params, st, median_depths, min_focals, max_focals)
        pts_i, pts_j = _corres_pts3d(st, K, cam2w, depth, focals)
        return {"intrinsics": _host(K), "cam2w": _host(cam2w), "depthmaps": _host(depth),
                "pts3d_i": _host(pts_i), "pts3d_j": _host(pts_j)}

    losses, seconds = {}, {}
    with no_tf32():
        t0 = _sync(device)
        losses["coarse"] = run_stage("coarse", lr1, niter1, stage1_keys)
        res_coarse = snapshot()
        seconds["coarse"] = _sync(device) - t0
        res_fine = None
        if niter2:
            t0 = _sync(device)
            losses["fine"] = run_stage("fine", lr2, niter2, stage2_keys)
            res_fine = snapshot()
            seconds["fine"] = _sync(device) - t0
    return {"coarse": res_coarse, "fine": res_fine, "losses": losses, "seconds": seconds}


def dense_pts3d(scene: SparseScene, res: Dict[str, np.ndarray]):
    """Densify the optimized anchor depths to full-resolution pointmaps
    through the canonical relative-depth offsets (get_dense_pts3d :71-95);
    gd3d's numpy."""
    H, W = scene.hw
    pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    out_pts, out_depth = [], []
    for i in range(scene.n_imgs):
        idx, off = anchor_depth_offsets(scene.canon2[i], pix, scene.subsample)
        K = res["intrinsics"][i]
        focal = K[0, 0]
        offc = 1.0 + (off - 1.0) * (scene.base_focals[i] / focal)
        z = res["depthmaps"][i][idx] * offc
        x = (pix[:, 0] - K[0, 2]) / K[0, 0] * z
        y = (pix[:, 1] - K[1, 2]) / K[1, 1] * z
        pts = np.stack([x, y, z], -1)
        cam2w = res["cam2w"][i]
        out_pts.append(pts @ cam2w[:3, :3].T + cam2w[:3, 3])
        out_depth.append(z.reshape(H, W))
    return out_pts, out_depth


def sparse_global_alignment(teacher, images: torch.Tensor, pairs=None, subsample: int = 8,
                            matching_conf_thr: float = 5.0, temperature: float = 1.0,
                            dtype: Optional[str] = None, **opt_kw):
    """Frozen MASt3R -> SparseScene -> two-stage optimization
    (sparse_global_alignment :119-156), on the images' device."""
    scene = build_scene_from_mast3r(teacher, images, pairs, subsample, matching_conf_thr,
                                    temperature, dtype)
    res = sparse_scene_optimizer(scene, device=images.device, **opt_kw)
    return scene, res
