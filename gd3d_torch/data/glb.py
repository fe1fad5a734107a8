"""Minimal glTF-2.0 binary (.glb) mesh loader, stdlib + numpy
(counterpart of gd3d/data/glb.py; textures decoded by data/images.py's
JPEG, PNG, BMP and WebP decoders instead of PIL, shadow maps rendered by
data/render_synthetic.py's rasteriser instead of gd3d's native library).

The reference renders real Objaverse assets (``<cad_root>/<name>.glb``,
data_utils/render_objects.py:33-41) through Blender/BlenderProc
(data_utils/blenderproc.py:13-87). Blender does not exist in this image, so
this loader parses the GLB container directly (JSON + BIN chunks), flattens
the node hierarchy, and merges all triangle primitives into one
``(verts, faces, vertex_colors)`` mesh that gd3d's z-buffer rasterizer
(data/render_synthetic.py, the arithmetic of gd3d's native
``gd3d_rasterize_mesh``) renders into
the reference's ``color_/depth_/mask_%06d.png`` tree layout.

Supported: node matrix/TRS transforms, indexed and non-indexed TRIANGLES /
TRIANGLE_STRIP / TRIANGLE_FAN primitives, u8/u16/u32 indices, POSITION,
COLOR_0 (u8/u16/float, VEC3/VEC4), TEXCOORD_0 + pbrMetallicRoughness
baseColorTexture (a PNG or JPEG decoded from the binary chunk to what
PIL's ``Image.open(f).convert("RGB")`` gives, which drops alpha without
compositing and expands grey and palette images, and sampled at the
vertex UVs — a per-vertex approximation of per-pixel texturing), and
baseColorFactor, and sparse accessors. Not supported (rare in Objaverse; we
fail loudly rather than render garbage): Draco/meshopt compression, external
buffer URIs. Animations/skins are ignored (static bind pose), matching the
reference renderer which never animates.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}
# normalization divisors for accessor.normalized integer data (glTF 3.6.2.2)
_NORM_MAX = {np.int8: 127.0, np.uint8: 255.0, np.int16: 32767.0,
             np.uint16: 65535.0, np.uint32: 4294967295.0}

_TRIANGLES, _TRIANGLE_STRIP, _TRIANGLE_FAN = 4, 5, 6


class Mesh:
    """Merged static mesh: world-space verts, int32 faces, float RGB."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 colors: np.ndarray):
        self.verts = verts
        self.faces = faces
        self.colors = colors


def read_glb_chunks(path) -> Tuple[dict, bytes]:
    """Parse the GLB container: 12-byte header + (JSON, BIN) chunks."""
    raw = Path(path).read_bytes()
    magic, version, _length = struct.unpack_from("<4sII", raw, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB file (magic {magic!r})")
    if version != 2:
        raise ValueError(f"{path}: unsupported glTF version {version}")
    offset, gltf, binary = 12, None, b""
    while offset + 8 <= len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        body = raw[offset + 8: offset + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf = json.loads(body)
        elif ctype == 0x004E4942:  # 'BIN\0'
            binary = bytes(body)
        # chunkLength includes the 4-byte alignment padding per spec
        offset += 8 + clen
    if gltf is None:
        raise ValueError(f"{path}: GLB has no JSON chunk")
    return gltf, binary


def _buffer_view_bytes(gltf: dict, binary: bytes, view_idx: int) -> bytes:
    view = gltf["bufferViews"][view_idx]
    if gltf["buffers"][view["buffer"]].get("uri"):
        raise ValueError("external buffer URIs are not supported (GLB only)")
    off = view.get("byteOffset", 0)
    return binary[off: off + view["byteLength"]]


def read_accessor(gltf: dict, binary: bytes, idx: int) -> np.ndarray:
    """Accessor -> (count, ncomp) array; normalized ints -> float [0, 1].
    Sparse accessors (glTF 3.6.2.3) apply (indices, values) overrides on
    top of the (possibly bufferView-less, zero-initialized) base."""
    acc = gltf["accessors"][idx]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    if "bufferView" not in acc:  # zero-initialized per spec
        data = np.zeros((count, ncomp), dtype)
    else:
        view = gltf["bufferViews"][acc["bufferView"]]
        raw = _buffer_view_bytes(gltf, binary, acc["bufferView"])
        off = acc.get("byteOffset", 0)
        stride = view.get("byteStride") or itemsize
        if stride == itemsize:
            data = np.frombuffer(
                raw, dtype, count=count * ncomp, offset=off
            ).reshape(count, ncomp)
        else:  # interleaved vertex data
            rows = np.frombuffer(raw, np.uint8)
            take = (off + np.arange(count)[:, None] * stride
                    + np.arange(itemsize)[None, :])
            data = rows[take].copy().view(dtype).reshape(count, ncomp)
    if "sparse" in acc:
        sp = acc["sparse"]
        n = sp["count"]

        def _sub(part: dict, sub_dtype, sub_ncomp: int) -> np.ndarray:
            raw_s = _buffer_view_bytes(gltf, binary, part["bufferView"])
            return np.frombuffer(
                raw_s, sub_dtype, count=n * sub_ncomp,
                offset=part.get("byteOffset", 0)).reshape(n, sub_ncomp)

        sidx = _sub(sp["indices"],
                    _COMPONENT_DTYPES[sp["indices"]["componentType"]], 1)
        svals = _sub(sp["values"], dtype, ncomp)
        data = data.copy()
        data[sidx[:, 0].astype(np.int64)] = svals
    if acc.get("normalized") and dtype in _NORM_MAX:
        data = data.astype(np.float32) / _NORM_MAX[dtype]
    return data


def _quat_to_mat(q) -> np.ndarray:
    x, y, z, w = q  # glTF stores (x, y, z, w)
    n = np.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _node_local(node: dict) -> np.ndarray:
    if "matrix" in node:  # column-major per spec
        return np.array(node["matrix"], float).reshape(4, 4).T
    M = np.eye(4)
    M[:3, :3] = _quat_to_mat(node.get("rotation", [0, 0, 0, 1]))
    M[:3, :3] = M[:3, :3] * np.asarray(node.get("scale", [1, 1, 1]), float)
    M[:3, 3] = node.get("translation", [0, 0, 0])
    return M


def _mesh_nodes(gltf: dict) -> List[Tuple[int, np.ndarray]]:
    """(mesh_index, world 4x4) for every mesh instance in the default scene
    (all root nodes if the file declares no scene)."""
    nodes = gltf.get("nodes", [])
    scenes = gltf.get("scenes", [])
    if scenes:
        roots = scenes[gltf.get("scene", 0)].get("nodes", [])
    else:
        children = {c for n in nodes for c in n.get("children", [])}
        roots = [i for i in range(len(nodes)) if i not in children]
    out: List[Tuple[int, np.ndarray]] = []

    def walk(idx: int, parent: np.ndarray) -> None:
        node = nodes[idx]
        world = parent @ _node_local(node)
        if "mesh" in node:
            out.append((node["mesh"], world))
        for c in node.get("children", []):
            walk(c, world)

    for r in roots:
        walk(r, np.eye(4))
    return out


def _decode_image(gltf: dict, binary: bytes, image_idx: int) -> np.ndarray:
    """Decode an embedded texture image -> (h, w, 3) float32 in [0, 1]:
    PIL's convert("RGB") of any format data/images.py decodes (alpha
    dropped, not composited)."""
    from gd3d_torch.data.images import decode_rgb

    img = gltf["images"][image_idx]
    if "bufferView" not in img:
        raise ValueError("external image URIs are not supported (GLB only)")
    data = _buffer_view_bytes(gltf, binary, img["bufferView"])
    rgb = decode_rgb(data, f"texture image {image_idx}", composite=False)
    return np.asarray(rgb, np.float32) / 255.0


def _sample_texture(tex: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear sample (h, w, 3) at (N, 2) UVs, REPEAT wrap (glTF default)."""
    h, w = tex.shape[:2]
    u = uv[:, 0] * w - 0.5
    v = uv[:, 1] * h - 0.5
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    tu, tv = (u - u0)[:, None], (v - v0)[:, None]
    u0, u1 = u0 % w, (u0 + 1) % w
    v0, v1 = v0 % h, (v0 + 1) % h
    top = tex[v0, u0] * (1 - tu) + tex[v0, u1] * tu
    bot = tex[v1, u0] * (1 - tu) + tex[v1, u1] * tu
    return top * (1 - tv) + bot * tv


def _primitive_base_color(gltf: dict, binary: bytes, prim: dict,
                          n_verts: int,
                          tex_cache: Dict[int, np.ndarray]) -> np.ndarray:
    """Per-vertex RGB: baseColorFactor x baseColorTexture(uv) x COLOR_0."""
    color = np.ones((n_verts, 3), np.float32) * 0.7  # untextured default
    mat = gltf.get("materials", [])
    midx = prim.get("material")
    if midx is not None and midx < len(mat):
        pbr = mat[midx].get("pbrMetallicRoughness", {})
        factor = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3]
        color = np.broadcast_to(factor, (n_verts, 3)).copy()
        tex_info = pbr.get("baseColorTexture")
        uv_attr = None
        if tex_info is not None:
            uv_attr = f"TEXCOORD_{tex_info.get('texCoord', 0)}"
        if tex_info is not None and uv_attr in prim["attributes"]:
            src = gltf["textures"][tex_info["index"]].get("source")
            if src is not None:
                if src not in tex_cache:
                    tex_cache[src] = _decode_image(gltf, binary, src)
                uv = read_accessor(
                    gltf, binary, prim["attributes"][uv_attr]
                ).astype(np.float64)
                color = color * _sample_texture(tex_cache[src], uv)
    if "COLOR_0" in prim["attributes"]:
        c0 = read_accessor(gltf, binary, prim["attributes"]["COLOR_0"])
        if np.issubdtype(c0.dtype, np.integer):
            # spec requires `normalized` on integer COLOR_0 (handled in
            # read_accessor); tolerate non-conforming exporters that omit it
            c0 = c0.astype(np.float32) / _NORM_MAX[c0.dtype.type]
        color = color * np.asarray(c0, np.float32)[:, :3]
    return np.clip(color, 0.0, 1.0)


def _triangulate(indices: np.ndarray, mode: int) -> Optional[np.ndarray]:
    idx = indices.reshape(-1)
    if mode == _TRIANGLES:
        return idx[: len(idx) - len(idx) % 3].reshape(-1, 3)
    if mode == _TRIANGLE_STRIP:
        if len(idx) < 3:
            return None
        a, b, c = idx[:-2], idx[1:-1], idx[2:]
        flip = np.arange(len(a)) % 2 == 1  # alternate winding per spec
        faces = np.stack([a, np.where(flip, c, b), np.where(flip, b, c)], 1)
        return faces
    if mode == _TRIANGLE_FAN:
        if len(idx) < 3:
            return None
        return np.stack(
            [np.full(len(idx) - 2, idx[0]), idx[1:-1], idx[2:]], 1)
    return None  # points/lines: nothing to rasterize


_COMPRESSED = ("KHR_draco_mesh_compression", "EXT_meshopt_compression")


def load_glb(path) -> Mesh:
    """Load a .glb into one merged world-space triangle mesh. A file that
    requires Draco or meshopt decompression raises a ValueError naming
    it (gd3d reads such a file's accessors as they stand and renders
    nothing useful)."""
    gltf, binary = read_glb_chunks(path)
    needed = [e for e in gltf.get("extensionsRequired", []) if e in _COMPRESSED]
    if needed:
        raise ValueError(f"{path}: compressed geometry ({', '.join(needed)}) is not supported")
    verts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []
    colors_all: List[np.ndarray] = []
    base = 0
    tex_cache: Dict[int, np.ndarray] = {}
    for mesh_idx, world in _mesh_nodes(gltf):
        for prim in gltf["meshes"][mesh_idx].get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = read_accessor(gltf, binary, attrs["POSITION"]).astype(
                np.float64)
            if "indices" in prim:
                idx = read_accessor(
                    gltf, binary, prim["indices"]).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            faces = _triangulate(idx, prim.get("mode", _TRIANGLES))
            if faces is None or len(faces) == 0:
                continue
            world_pos = pos @ world[:3, :3].T + world[:3, 3]
            verts_all.append(world_pos)
            faces_all.append(faces + base)
            colors_all.append(
                _primitive_base_color(gltf, binary, prim, len(pos),
                                      tex_cache))
            base += len(pos)
    if not verts_all:
        raise ValueError(f"{path}: no triangle geometry found")
    return Mesh(
        np.concatenate(verts_all),
        np.concatenate(faces_all).astype(np.int32),
        np.concatenate(colors_all),
    )


def normalize_unit_box(verts: np.ndarray) -> np.ndarray:
    """The reference's object normalization (blenderproc.py:42-59): scale the
    bound box's longest side to 1, then center at the origin."""
    lo, hi = verts.min(0), verts.max(0)
    scale = 1.0 / max(float((hi - lo).max()), 1e-12)
    center = (lo + hi) / 2.0 * scale
    return verts * scale - center


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for the Lambert shading substitute)."""
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )  # magnitude = 2x area: the weighting
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


# The reference's light rig (blenderproc.py:21-35) in CV camera coordinates.
# BlenderProc places the camera at the Blender-world origin with the
# ["X", "-Y", "-Z"] source-frame change (blenderproc.py:16), so a Blender
# world position (x, y, z) is (x, -y, -z) in CV camera coords. Note the
# reference's third Light() has set_type/location/energy called twice
# (blenderproc.py:29-35) so only (20 W at [1, 0, 1]) survives — mirrored
# faithfully here.
LIGHTS_CAM = np.array([[1.0, 1.0, -1.0], [-1.0, 1.0, 1.0], [1.0, 0.0, -1.0]])
_LIGHT_ENERGY = np.array([200.0, 200.0, 20.0])
_AMBIENT = 0.10


def shade_lambert(cam_verts: np.ndarray, cam_normals: np.ndarray,
                  colors: np.ndarray,
                  visibility: Optional[np.ndarray] = None) -> np.ndarray:
    """Diffuse point-light shading in camera space (lights ride the camera,
    as in the reference where the OBJECT moves and the rig stays fixed,
    blenderproc.py:66-68). Inverse-square falloff, exposure-normalized.

    `visibility` (n_lights, V) in [0, 1] gates each light's contribution
    per vertex — the shadow term computed by `light_visibility` (the
    reference's path tracer casts shadows natively; Lambert alone lights
    concave regions a ray-traced render leaves dark)."""
    shade = np.zeros(len(cam_verts))
    for li, (pos, energy) in enumerate(zip(LIGHTS_CAM, _LIGHT_ENERGY)):
        to_light = pos - cam_verts
        d2 = np.maximum((to_light ** 2).sum(-1), 1e-6)
        ndotl = (cam_normals * to_light).sum(-1) / np.sqrt(d2)
        # two-sided: glb meshes are frequently inconsistently wound
        contrib = energy / d2 * np.abs(ndotl)
        if visibility is not None:
            contrib = contrib * visibility[li]
        shade = shade + contrib
    ref = _LIGHT_ENERGY.sum() / 4.0  # exposure anchor: unit distance
    s = np.clip(_AMBIENT + (1 - _AMBIENT) * shade / ref, 0.0, 1.0)
    return colors * s[:, None].astype(colors.dtype)


def light_visibility(cam_verts: np.ndarray, faces: np.ndarray,
                     light_pos: np.ndarray, res: int = 256) -> np.ndarray:
    """Per-vertex shadow term for one point light via shadow mapping:
    render the mesh's depth from the light with the SAME native z-buffer
    rasterizer the color pass uses (depth only), then mark vertices whose
    distance to the light exceeds the shadow-map sample as occluded.
    Returns (V,) in {0, 1}."""
    from gd3d_torch.data.render_synthetic import rasterize_mesh

    light_pos = np.asarray(light_pos, np.float64)
    center = cam_verts.mean(0)
    fwd = center - light_pos
    fn = np.linalg.norm(fwd)
    if fn < 1e-9:
        return np.ones(len(cam_verts))
    fwd = fwd / fn
    up = np.array([0.0, 0.0, 1.0])
    if abs(up @ fwd) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    lv = (cam_verts - light_pos) @ R.T  # light space, +z toward mesh

    # frustum wide enough for every vertex in front of the light
    front = lv[:, 2] > 1e-6
    if not front.any():
        return np.ones(len(cam_verts))
    tan = np.abs(lv[front, :2] / lv[front, 2:3]).max()
    tan = min(max(tan * 1.05, 0.1), 12.0)  # clamp to ~85 deg half-angle
    f = (res / 2.0) / tan
    K_l = np.array([[f, 0.0, res / 2.0], [0.0, f, res / 2.0],
                    [0.0, 0.0, 1.0]])
    depth = rasterize_mesh(lv, faces, None, K_l, res, res)[1]  # +inf on empty

    u = np.clip((lv[:, 0] / np.maximum(lv[:, 2], 1e-8) * f
                 + res / 2.0).astype(int), 0, res - 1)
    v = np.clip((lv[:, 1] / np.maximum(lv[:, 2], 1e-8) * f
                 + res / 2.0).astype(int), 0, res - 1)
    seen = depth[v, u]
    # depth-proportional bias absorbs vertex-resolution acne
    lit = lv[:, 2] <= seen * 1.02 + 2.0 / res
    # vertices behind the light plane receive no light anyway (|n.l| term
    # still applies); count them visible
    return np.where(front, lit, True).astype(np.float64)
