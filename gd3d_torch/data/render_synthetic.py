"""The procedural renderer's meshes, cameras and z-buffer rasteriser
(counterpart of the part of gd3d/data/render_synthetic.py that the
pretraining pairs use: DEFAULT_INTRINSIC, fixed_poses, icosphere,
procedural_object and render_mesh without shading).

gd3d rasterises through its native library (native/gd3d_native.cpp,
gd3d_rasterize_mesh); `render_mesh` here follows that arithmetic, so the
pixels, depths and masks are the same bits:

- per vertex u = (fx X + s Y + cx z) / max(z, 1e-8) and v likewise, as a
  product with the reciprocal;
- faces with a vertex at z <= 0.05 are skipped, as are empty boxes and
  degenerate triangles (|det| < 1e-12);
- float64 barycentrics at the pixel centres, perspective-correct depth
  1 / sum(w_i / z_i);
- a float32 z-buffer and colour, faces taken in order: a face replaces a
  pixel only where its float64 depth is below the stored float32 one.

The faces are rasterised together: every (face, pixel) candidate of every
bounding box at once, then the z-test runs over the candidates of each
pixel in face order, one rank at a time (a pixel's first candidates, then
its second ones, ...), which gives what the sequential loop gives.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_INTRINSIC = np.array(
    [[35 * 512 / 32.0, 0.0, 256.0], [0.0, 35 * 512 / 32.0, 256.0],
     [0.0, 0.0, 1.0]]
)  # data_utils/dataset.py:38-40


def fixed_poses(n: int = 42, radius: float = 2.0,
                seed: int = 0) -> np.ndarray:
    """n camera extrinsics (4x4 world->cam) on a sphere looking at origin —
    the analogue of data/obj_poses.npy."""
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        # Fibonacci sphere directions for even coverage
        z = 1 - 2 * (i + 0.5) / n
        r = np.sqrt(max(0.0, 1 - z * z))
        phi = i * np.pi * (3 - np.sqrt(5.0))
        cam_pos = radius * np.array([r * np.cos(phi), r * np.sin(phi), z])
        fwd = -cam_pos / np.linalg.norm(cam_pos)
        up = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(up, fwd)) > 0.99:
            up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])  # rows: cam axes in world
        t = -R @ cam_pos
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = t
        poses.append(E)
    return np.stack(poses)


def icosphere(subdiv: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        float,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdiv):
        new_faces = []
        verts = list(map(np.array, verts))
        cache = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (verts[a] + verts[b]) / 2
                m = m / np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for f in faces:
            a, b, c = f
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.stack(verts)
        faces = np.array(new_faces)
    return verts, faces


def procedural_object(rng: np.random.RandomState
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random bumpy sphere with per-vertex colors, radius ~0.3."""
    verts, faces = icosphere(2)
    bump = 1.0 + 0.25 * np.sin(
        verts @ rng.randn(3, 3) * 3.0
    ).sum(-1) / 3.0
    verts = verts * bump[:, None] * (0.25 + 0.1 * rng.rand())
    colors = 0.2 + 0.8 * np.abs(np.sin(verts * 17 + rng.rand(3) * 6))
    return verts, faces, colors


def render_mesh(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
                extrinsic: np.ndarray, K: np.ndarray, size: int = 512
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterisation -> (rgb uint8, depth float32 metres, mask
    bool), as gd3d's render_mesh through its native library."""
    cam = np.ascontiguousarray(verts @ extrinsic[:3, :3].T + extrinsic[:3, 3], np.float64)
    faces = np.asarray(faces, np.int64)
    colors = np.asarray(colors, np.float32)
    K = np.asarray(K, np.float64)
    H = W = size
    rgb = np.zeros((H * W, 3), np.float32)
    zbuf = np.full(H * W, np.inf, np.float32)

    fx, sk, cx, fy, cy = K[0, 0], K[0, 1], K[0, 2], K[1, 1], K[1, 2]
    X, Y, z = cam[:, 0], cam[:, 1], cam[:, 2]
    zi = 1.0 / np.maximum(z, 1e-8)
    u = (fx * X + sk * Y + cx * z) * zi
    v = (fy * Y + cy * z) * zi

    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    za, zb, zc = z[a], z[b], z[c]
    x0, y0, x1, y1, x2, y2 = u[a], v[a], u[b], v[b], u[c], v[c]
    with np.errstate(invalid="ignore", over="ignore"):
        lx = np.maximum(0, np.floor(np.minimum(np.minimum(x0, x1), x2)))
        ly = np.maximum(0, np.floor(np.minimum(np.minimum(y0, y1), y2)))
        hx = np.minimum(W, np.ceil(np.maximum(np.maximum(x0, x1), x2)) + 1)
        hy = np.minimum(H, np.ceil(np.maximum(np.maximum(y0, y1), y2)) + 1)
    d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    keep = ((za > 0.05) & (zb > 0.05) & (zc > 0.05) & (hx > lx) & (hy > ly)
            & (np.abs(d) >= 1e-12))
    f = np.nonzero(keep)[0]
    lx, ly = lx[f].astype(np.int64), ly[f].astype(np.int64)
    bw, bh = hx[f].astype(np.int64) - lx, hy[f].astype(np.int64) - ly
    counts = bw * bh
    if counts.sum() == 0:
        return (np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.float32),
                np.zeros((H, W), bool))

    # every candidate pixel of every box, faces in order
    cf = np.repeat(np.arange(len(f)), counts)
    k = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    px = lx[cf] + k % bw[cf]
    py = ly[cf] + k // bw[cf]
    qx, qy = px + 0.5, py + 0.5
    fi = f[cf]
    X0, Y0, X1, Y1, X2, Y2, D = (t[fi] for t in (x0, y0, x1, y1, x2, y2, d))
    w0 = ((Y1 - Y2) * (qx - X2) + (X2 - X1) * (qy - Y2)) / D
    w1 = ((Y2 - Y0) * (qx - X2) + (X0 - X2) * (qy - Y2)) / D
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    fi, w0, w1, w2 = fi[inside], w0[inside], w1[inside], w2[inside]
    pix = (py * W + px)[inside]
    iza, izb, izc = 1.0 / za[fi], 1.0 / zb[fi], 1.0 / zc[fi]
    pz = 1.0 / (w0 * iza + w1 * izb + w2 * izc)

    # the z-test in face order within each pixel, one rank at a time
    order = np.argsort(pix, kind="stable")
    spix = pix[order]
    start = np.r_[0, np.nonzero(np.diff(spix))[0] + 1]
    run = np.diff(np.r_[start, len(spix)])
    rank = np.arange(len(spix)) - np.repeat(start, run)
    winner = np.full(H * W, -1, np.int64)
    for r in range(int(run.max()) if len(run) else 0):
        cand = order[rank == r]
        p = pix[cand]
        closer = pz[cand] < zbuf[p]
        zbuf[p[closer]] = pz[cand[closer]].astype(np.float32)
        winner[p[closer]] = cand[closer]

    hit = np.nonzero(winner >= 0)[0]
    wc = winner[hit]
    wa, wb, wcc = w0[wc] * iza[wc] * pz[wc], w1[wc] * izb[wc] * pz[wc], w2[wc] * izc[wc] * pz[wc]
    ca, cb, cc = colors[a[fi[wc]]], colors[b[fi[wc]]], colors[c[fi[wc]]]
    rgb[hit] = (wa[:, None] * ca + wb[:, None] * cb + wcc[:, None] * cc).astype(np.float32)

    depth = zbuf.reshape(H, W)
    mask = np.isfinite(depth)
    depth = np.where(mask, depth, 0.0)
    return (np.clip(rgb.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8), depth, mask
