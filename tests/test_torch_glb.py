"""The port's .glb loader and shading (gd3d_torch/data/glb.py) against
gd3d's (gd3d/data/glb.py).

On the fixture asset (data/fixtures.py::write_glb: an RGBA PNG texture,
a JPEG texture, COLOR_0, a triangle strip, a sparse accessor, TRS and
matrix nodes) and on gd3d's own test scenes: vertices and faces equal,
colours to 1e-6 (they are equal). Texture decoding equals PIL's
convert("RGB") for RGBA (alpha dropped, not composited), grey, grey+alpha,
palette with transparency, 16-bit grey and JPEG images. Lambert shading
and the shadow maps equal gd3d's through its native library bit for bit."""
import io

import numpy as np
import pytest
from PIL import Image

import gd3d.data.glb as J
import gd3d_torch.data.glb as T
from gd3d import native_runtime
from gd3d_torch.data import fixtures
from gd3d_torch.data.render_synthetic import fixed_poses, procedural_object
from tests.test_glb import _quad_scene_glb


def assert_mesh_equal(got, want):
    np.testing.assert_array_equal(got.verts, want.verts)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == want.faces.dtype
    np.testing.assert_allclose(got.colors, want.colors, rtol=0, atol=1e-6)


def test_fixture_asset_equals_gd3d(tmp_path):
    path = fixtures.write_glb(tmp_path / fixtures.GLB_NAME)
    got, want = T.load_glb(path), J.load_glb(path)
    assert_mesh_equal(got, want)
    assert got.faces.shape == (84, 3) and len(got.verts) == 48
    # the strip's sparse POSITION: 4 of 6 vertices overridden, 2 at the base
    assert (got.verts[-4:-2] == got.verts[-4]).all()
    for f in (T.normalize_unit_box, ):
        np.testing.assert_array_equal(f(got.verts), J.normalize_unit_box(want.verts))
    np.testing.assert_array_equal(T.vertex_normals(got.verts, got.faces),
                                  J.vertex_normals(want.verts, want.faces))


@pytest.mark.parametrize("textured", [False, True])
def test_gd3d_test_scenes_equal(tmp_path, textured):
    path = tmp_path / "scene.glb"
    path.write_bytes(_quad_scene_glb(with_texture=textured))
    assert_mesh_equal(T.load_glb(path), J.load_glb(path))


def _texture_cases():
    rng = np.random.RandomState(0)
    rgba = rng.randint(0, 256, (9, 13, 4)).astype(np.uint8)
    cases = {"rgba": Image.fromarray(rgba, "RGBA"),
             "rgb": Image.fromarray(rgba[..., :3]),
             "grey": Image.fromarray(rgba[..., 0]),
             "grey_alpha": Image.fromarray(rgba[..., :2], "LA"),
             "grey16": Image.fromarray((rgba[..., 0].astype(np.uint16) * 257)),
             "palette": Image.fromarray(rgba[..., :3]).quantize(64)}
    cases["palette"].info["transparency"] = 2
    out = {}
    for name, im in cases.items():
        buf = io.BytesIO()
        im.save(buf, "PNG", **({"transparency": 2} if name == "palette" else {}))
        out[name] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgba[..., :3]).save(buf, "JPEG", quality=90)
    out["jpeg"] = buf.getvalue()
    return out


@pytest.mark.parametrize("name", list(_texture_cases()))
def test_texture_decode_equals_pil(name):
    data = _texture_cases()[name]
    gltf = {"buffers": [{"byteLength": len(data)}],
            "bufferViews": [{"buffer": 0, "byteLength": len(data)}],
            "images": [{"bufferView": 0}]}
    got = T._decode_image(gltf, data, 0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, J._decode_image(gltf, data, 0))


def test_refusals(tmp_path):
    data = b"GIF89a" + bytes(16)
    gltf = {"buffers": [{"byteLength": len(data)}],
            "bufferViews": [{"buffer": 0, "byteLength": len(data)}],
            "images": [{"bufferView": 0}, {"uri": "tex.png"}]}
    with pytest.raises(ValueError, match="not a JPEG, PNG, BMP or WebP"):
        T._decode_image(gltf, data, 0)
    with pytest.raises(ValueError, match="external image"):
        T._decode_image(gltf, data, 1)
    gltf = {"buffers": [{"uri": "a.bin", "byteLength": 4}],
            "bufferViews": [{"buffer": 0, "byteLength": 4}]}
    with pytest.raises(ValueError, match="external buffer"):
        T._buffer_view_bytes(gltf, b"", 0)
    path = fixtures.write_glb(tmp_path / "a.glb")
    raw = path.read_bytes()
    # the same asset with Draco declared as required
    import json
    import struct

    n = struct.unpack_from("<I", raw, 12)[0]
    gl = json.loads(raw[20:20 + n])
    gl["extensionsRequired"] = ["KHR_draco_mesh_compression"]
    body = json.dumps(gl).encode()
    body += b" " * ((-len(body)) % 4)
    rest = raw[20 + n:]
    (tmp_path / "d.glb").write_bytes(struct.pack("<4sII", b"glTF", 2, 20 + len(body) + len(rest))
                                     + struct.pack("<II", len(body), 0x4E4F534A) + body + rest)
    with pytest.raises(ValueError, match="KHR_draco_mesh_compression"):
        T.load_glb(tmp_path / "d.glb")


def test_shading_and_shadows_equal_gd3d():
    assert native_runtime.available(), "gd3d's shadow maps must run its native library here"
    verts, faces, colors = procedural_object(np.random.RandomState(3))
    normals = T.vertex_normals(verts, faces)
    E = fixed_poses(5)[2]
    cam = verts @ E[:3, :3].T + E[:3, 3]
    cn = normals @ E[:3, :3].T
    for lp in T.LIGHTS_CAM:
        got, want = T.light_visibility(cam, faces, lp), J.light_visibility(cam, faces, lp)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1  # some vertices in shadow
    vis = np.stack([T.light_visibility(cam, faces, lp) for lp in T.LIGHTS_CAM])
    c32 = colors.astype(np.float32)
    for v in (None, vis):
        got, want = T.shade_lambert(cam, cn, c32, v), J.shade_lambert(cam, cn, c32, v)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
