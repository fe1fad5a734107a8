"""The procedural renderer: meshes, cameras, the z-buffer rasteriser and
the Objaverse-layout tree writer (counterpart of
gd3d/data/render_synthetic.py: DEFAULT_INTRINSIC, fixed_poses, icosphere,
procedural_object, render_mesh with its Lambert shading and shadows, and
render_object_tree).

gd3d rasterises through its native library (native/gd3d_native.cpp,
gd3d_rasterize_mesh); `rasterize_mesh` here follows that arithmetic, so the
pixels, depths and masks are the same bits:

- per vertex u = (fx X + s Y + cx z) / max(z, 1e-8) and v likewise, as a
  product with the reciprocal;
- faces with a vertex at z <= 0.05 are skipped, as are empty boxes and
  degenerate triangles (|det| < 1e-12);
- float64 barycentrics at the pixel centres, perspective-correct depth
  1 / sum(w_i / z_i);
- a float32 z-buffer and colour, faces taken in order: a face replaces a
  pixel only where its float64 depth is below the stored float32 one.

The faces are rasterised together, in face-ordered chunks of at most
CHUNK (face, pixel) candidates (every pixel of each face's bounding box),
so that memory stays bounded on a scan mesh of 10^5-10^6 faces. Within a
chunk the z-test runs over the candidates of each pixel in face order, one
rank at a time (a pixel's first candidates, then its second ones, ...);
the chunks follow one another, which together gives what the sequential
loop gives.

gd3d writes the tree's PNGs with cv2.imwrite; the port writes them with
data/png.py's encoder, which decodes to the same pixels.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# (face, pixel) candidates rasterised at once
CHUNK = 1 << 20

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


def rasterize_mesh(cam: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray],
                   K: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffer camera-space triangles into an (h, w) frame -> (rgb float32
    (h, w, 3), depth float32 (h, w), +inf where nothing was drawn), as
    gd3d's native_runtime.rasterize_mesh. With `colors` None the colour
    pass is skipped and rgb is all zeros (a depth-only render)."""
    cam = np.ascontiguousarray(cam, np.float64)
    faces = np.asarray(faces, np.int64)
    K = np.asarray(K, np.float64)
    H, W = int(h), int(w)
    rgb = np.zeros((H * W, 3), np.float32)
    zbuf = np.full(H * W, np.inf, np.float32)
    if colors is not None:
        colors = np.asarray(colors, np.float32)

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
    ends = np.cumsum(counts)
    lo = 0
    while lo < len(f):
        base = ends[lo - 1] if lo else 0
        hi = max(int(np.searchsorted(ends, base + CHUNK, side="right")), lo + 1)
        sl = slice(lo, hi)
        _raster_chunk(f[sl], lx[sl], ly[sl], bw[sl], counts[sl], W, (x0, y0, x1, y1, x2, y2, d),
                      (za, zb, zc), (a, b, c), colors, zbuf, rgb)
        lo = hi
    return rgb.reshape(H, W, 3), zbuf.reshape(H, W)


def _raster_chunk(f, lx, ly, bw, counts, W, tri, zs, abc, colors, zbuf, rgb) -> None:
    """Rasterise faces f (in order) into zbuf and rgb, in place."""
    x0, y0, x1, y1, x2, y2, d = tri
    za, zb, zc = zs
    # every candidate pixel of every box, faces in order
    cf = np.repeat(np.arange(len(f)), counts)
    k = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
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
    if not len(pix):
        return
    iza, izb, izc = 1.0 / za[fi], 1.0 / zb[fi], 1.0 / zc[fi]
    pz = 1.0 / (w0 * iza + w1 * izb + w2 * izc)

    # the z-test in face order within each pixel, one rank at a time
    order = np.argsort(pix, kind="stable")
    spix = pix[order]
    start = np.r_[0, np.nonzero(np.diff(spix))[0] + 1]
    run = np.diff(np.r_[start, len(spix)])
    rank = np.arange(len(spix)) - np.repeat(start, run)
    winner = np.full(len(zbuf), -1, np.int64)
    for r in range(int(run.max())):
        cand = order[rank == r]
        p = pix[cand]
        closer = pz[cand] < zbuf[p]
        zbuf[p[closer]] = pz[cand[closer]].astype(np.float32)
        winner[p[closer]] = cand[closer]

    if colors is None:
        return
    hit = np.nonzero(winner >= 0)[0]
    wc = winner[hit]
    a, b, c = (t[fi[wc]] for t in abc)
    wa, wb, wcc = w0[wc] * iza[wc] * pz[wc], w1[wc] * izb[wc] * pz[wc], w2[wc] * izc[wc] * pz[wc]
    rgb[hit] = (wa[:, None] * colors[a] + wb[:, None] * colors[b]
                + wcc[:, None] * colors[c]).astype(np.float32)


def render_mesh(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
                extrinsic: np.ndarray, K: np.ndarray, size: int = 512,
                normals: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterisation -> (rgb uint8, depth float32 metres, mask
    bool), as gd3d's render_mesh through its native library. With
    `normals` (world-space vertex normals) the colours are Lambert-shaded
    under the camera-fixed light rig (data/glb.py::shade_lambert), each
    light gated by its shadow map unless GD3D_RENDER_SHADOWS is "0", as in
    gd3d."""
    cam = verts @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if normals is not None:
        from gd3d_torch.data.glb import LIGHTS_CAM, light_visibility, shade_lambert

        cam_normals = normals @ extrinsic[:3, :3].T
        vis = None
        if os.environ.get("GD3D_RENDER_SHADOWS", "1") != "0":
            vis = np.stack([light_visibility(cam, faces, lp) for lp in LIGHTS_CAM])
        colors = shade_lambert(cam, cam_normals, np.asarray(colors, np.float32), visibility=vis)
    rgb, depth = rasterize_mesh(cam, faces, colors, K, size, size)
    mask = np.isfinite(depth)
    depth = np.where(mask, depth, 0.0)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8), depth, mask


def render_object_tree(out_dir, obj_names: List[str], n_views: int = 42, size: int = 512,
                       seed: int = 0, glb_root=None, poses: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Write <out_dir>/<name>/{color,depth,mask}_%06d.png for each object
    and return the poses, as gd3d's render_object_tree: RGB colour, depth
    in mm as uint16, the mask as uint8 0 / 255. With `glb_root` each name
    is <glb_root>/<name>.glb, loaded by data/glb.py, unit-box normalised
    and Lambert-shaded; otherwise object i is procedural_object of
    RandomState(seed + i)."""
    from gd3d_torch.data.png import encode_png

    if poses is None:
        poses = fixed_poses(n_views)
    else:
        poses = np.asarray(poses)[:n_views]
        assert poses.shape == (n_views, 4, 4), poses.shape
    K = DEFAULT_INTRINSIC * (size / 512.0)
    K[2, 2] = 1.0
    for oi, name in enumerate(obj_names):
        normals = None
        if glb_root is not None:
            from gd3d_torch.data import glb as glb_mod

            mesh = glb_mod.load_glb(Path(glb_root) / (name if name.endswith(".glb") else name + ".glb"))
            verts = glb_mod.normalize_unit_box(mesh.verts)
            faces, colors = mesh.faces, mesh.colors
            normals = glb_mod.vertex_normals(verts, faces)
        else:
            verts, faces, colors = procedural_object(np.random.RandomState(seed + oi))
        # strip only a .glb suffix: names may be nested ("000-000/obj0")
        d = Path(out_dir) / (name[:-4] if name.endswith(".glb") else name)
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_views):
            rgb, depth, mask = render_mesh(verts, faces, colors, poses[i], K, size, normals=normals)
            for kind, arr in (("color", rgb), ("depth", (depth * 1000).astype(np.uint16)),
                              ("mask", mask.astype(np.uint8) * 255)):
                (d / f"{kind}_{i:06d}.png").write_bytes(encode_png(arr))
    return poses
