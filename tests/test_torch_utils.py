"""The last modules, on the CPU: ops/masks.py::masked_patch_cost in its four
modes, utils/misc.py, the YAML reader behind it (core/yaml_reader.py) and
utils/vis.py, each against gd3d's function (or yaml.safe_load) on the same
numpy-seeded inputs.

Tolerances: masked_patch_cost 1e-6 of max(1, |ref|) in fp32 (one sum and
one division a row; exp of the same fp32 inputs under softmax); misc.py,
the YAML reader, vis_attn_map and visualize_tracking_results exactly (the
JPEG files' decoded pixels and bytes); visualize_matching_pairs and
visualize_depth_maps on their panel pixels (where the port draws, two
pixels in from every edge, titles and tick labels not drawn): the mean of
the largest channel difference at most 4 / 255, and at most 2% of those
pixels off by more than 64 (Agg antialiases edges and dots, and snaps the
image to its pixel grid, which can move a panel by up to half a pixel; its
filter weights are fixed point).
"""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from scipy import ndimage

import gd3d.ops.masks as jm
import gd3d.utils.misc as jmisc
import gd3d.utils.vis as jvis
import gd3d_torch.ops.masks as tm
import gd3d_torch.utils.misc as tmisc
import gd3d_torch.utils.vis as tvis
from gd3d_torch.core.yaml_reader import loads, read_yaml
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("columns", [False, True])
def test_masked_patch_cost_matches_gd3d_in_every_mode(use_softmax, columns):
    rng = np.random.RandomState(int(use_softmax) * 2 + int(columns))
    B, hw, hw2 = 2, 24, 30
    cost = rng.rand(B, hw, hw2).astype(np.float32) * 3 - 0.5
    m1 = rng.rand(hw) > 0.4
    m2 = rng.rand(hw2) > 0.3 if columns else None
    kw = dict(use_softmax=use_softmax, temperature=0.07 if use_softmax else 1.0, eps=1e-6)
    got = tm.masked_patch_cost(torch.from_numpy(cost), torch.from_numpy(m1),
                               None if m2 is None else torch.from_numpy(m2), **kw)
    want = np.asarray(jm.masked_patch_cost(jnp.asarray(cost), jnp.asarray(m1),
                                           None if m2 is None else jnp.asarray(m2), **kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-6 * max(1.0, float(np.abs(want).max())), err
    if use_softmax:  # zeroed rows are uniform, as gd3d's docstring states
        np.testing.assert_allclose(got.numpy()[:, ~m1], 1.0 / hw2, rtol=1e-6)
    else:
        assert not got.numpy()[:, ~m1].any()


def test_masked_patch_cost_bf16_softmax_runs_in_fp32():
    cost = torch.rand((1, 8, 8)).to(torch.bfloat16)
    m = torch.tensor([True, False] * 4)
    out = tm.masked_patch_cost(cost, m, m, use_softmax=True, temperature=0.5)
    assert out.dtype == torch.float32
    assert torch.allclose(out.sum(-1), torch.ones((1, 8)), atol=1e-6)


def test_rotation_angle_matches_gd3d():
    rng = np.random.RandomState(0)
    for _ in range(10):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        R = q * np.sign(np.linalg.det(q))
        assert tmisc.rotation_angle_from_matrix(R) == jmisc.rotation_angle_from_matrix(R)
    assert tmisc.rotation_angle_from_matrix(np.eye(3)) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_resize_crop_matches_gd3d(seed):
    """PIL's getbbox, float-box crop (rounding, zero fill outside the image)
    and bicubic resize, on RGB and grey images, with and without a bbox."""
    rng = np.random.RandomState(seed)
    for trial in range(6):
        H, W = rng.randint(12, 100, 2)
        img = np.zeros((H, W, 3) if trial % 3 else (H, W), np.uint8)
        y0, x0 = rng.randint(0, H - 4), rng.randint(0, W - 4)
        y1, x1 = rng.randint(y0 + 2, H), rng.randint(x0 + 2, W)
        img[y0:y1, x0:x1] = rng.randint(1, 256, img[y0:y1, x0:x1].shape)
        kw = dict(padding=float(rng.uniform(0, 0.6)), out_size=int(rng.choice([16, 33, 64])))
        if trial % 2:
            kw["bbox"] = (int(x0), int(y0), int(x1), int(y1))
        got, t_got = tmisc.resize_crop(img, **kw)
        want, t_want = jmisc.resize_crop(img, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(t_got, t_want)


def test_resize_crop_of_the_gd3d_test_image():
    img = np.zeros((64, 64, 3), np.uint8)
    img[20:40, 10:50] = 255
    got, T = tmisc.resize_crop(img, out_size=32)
    want, T_want = jmisc.resize_crop(img, out_size=32)
    assert np.array_equal(got, want) and np.array_equal(T, T_want)
    with pytest.raises(ValueError, match="all zero"):
        tmisc.resize_crop(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8 RGB or grey"):
        tmisc.resize_crop(np.zeros((8, 8, 4), np.uint8))


YAML_DOCS = [
    "a: 1\nb:\n  - x\n  - y\n",  # gd3d's tests/test_misc_grain.py input
    "a: 1\nb:\n- x\n- y\nc: 'q''s'\nd: \"t\\n\\u00e9\"\n",
    "n: ~\nm: null\ne:\nt: yes\nf: Off\ni: 0x1F\no: 017\nb: 0b101\ns: 1:30\nu: 1_000\n"
    "fl: 1.5\nfe: 1.0e+3\nne: 1e3\ninf: -.inf\nx: 1.2.3\nneg: -5\nw: .5\nv: 3.\n",
    "top:\n  inner:\n    k: v  # comment\n    l: [1, 2, [3, 'a b']]\n"
    "  m: {a: 1, b: [x, y], 'c d': null}\n# full comment\nlist:\n  - a: 1\n    b: 2\n"
    "  - - 1\n    - 2\n  -\n    z: 3\n  - plain text here\n",
    "- 1\n- two\n- {k: v}\n",
    "just a scalar\n",
    "",
    "key: value # with comment\nurl: http://x.y/z#frag\nq: 'a # not comment'\n",
    "1: one\n2.5: two\ntrue: t\nempty: []\nnone: {}\n",
]


@pytest.mark.parametrize("i", range(len(YAML_DOCS)))
def test_yaml_reader_gives_safe_load(i, tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(YAML_DOCS[i])
    want = yaml.safe_load(YAML_DOCS[i])
    assert repr(tmisc.parse_yaml(str(p))) == repr(want)
    if i == 0:
        assert tmisc.parse_yaml(str(p)) == jmisc.parse_yaml(str(p)) == {"a": 1, "b": ["x", "y"]}


def test_yaml_reader_reads_every_yaml_of_the_repo():
    paths = [os.path.join(d, f) for pkg in ("gd3d", "gd3d_torch")
             for d, _, files in os.walk(os.path.join(REPO, pkg)) for f in files
             if f.endswith((".yaml", ".yml"))]
    assert len(paths) >= 10
    for path in paths:
        with open(path) as f:
            assert read_yaml(path) == yaml.safe_load(f), path


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\nb: *x\n", "'&'"), ("a: !!str 1\n", "'!'"), ("a: |\n  text\n", "'|'"),
    ("a: >\n  t\n", "'>'"), ("---\na: 1\n", "document marker"), ("? a\n: b\n", "complex"),
    ("<<: {a: 1}\n", "merge"), ("a: 2001-12-14\n", "timestamp"),
    ("a: b\n  c\n", "several lines"), ("a:\n\t- x\n", "tab"), ("a: 'x\n  y'\n", "several lines"),
    ("a: [1, 2\n", "unclosed"),
])
def test_yaml_reader_refuses_by_name(text, what):
    with pytest.raises(ValueError, match=f"cannot read.*{what}"):
        loads(text)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vis_attn_map_gives_cv2s_file(dtype, tmp_path):
    rng = np.random.RandomState(1)
    H, W, p = 96, 128, 16
    hw = (H // p) * (W // p)
    attn = rng.rand(hw, hw).astype(dtype)
    tgt, src = (rng.rand(H, W, 3).astype(np.float32) for _ in range(2))
    want = jvis.vis_attn_map(attn, tgt, src, 7, p_size=p, save_path=str(tmp_path / "j"))
    got = tvis.vis_attn_map(attn, tgt, src, 7, p_size=p, save_path=str(tmp_path / "t"))
    assert os.path.basename(got) == os.path.basename(want) == "count7_all_points.jpg"
    assert np.array_equal(cv2.imread(got), cv2.imread(want))
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_visualize_tracking_results_gives_cv2s_files(tmp_path):
    """Discs clipped at every border (points off the frame included),
    occluded and visible colours, later tracks over earlier ones."""
    rng = np.random.RandomState(2)
    imgs = rng.rand(3, 40, 50, 3).astype(np.float32)
    trajs = {0: rng.uniform(-4, 54, (8, 3, 2)), 2: rng.uniform(0, 50, (5, 3, 2))}
    occ = {0: rng.rand(8, 3) > 0.5}
    want = jvis.visualize_tracking_results(imgs, trajs, occ, str(tmp_path / "j"))
    got = tvis.visualize_tracking_results(imgs, trajs, occ, str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert np.array_equal(cv2.imread(a), cv2.imread(b))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _panel_diff(got_path, want_path):
    got = np.asarray(Image.open(got_path)).astype(np.int64)
    want = np.asarray(Image.open(want_path)).astype(np.int64)
    assert got.shape == want.shape == (500, 1500, 4)
    panel = ndimage.binary_erosion((got[..., :3] != 255).any(-1), iterations=2)
    d = np.abs(got - want)[..., :3].max(-1)[panel]
    return panel.sum(), d.mean(), (d > 64).mean()


def _blocks(h, w, seed):
    """An image of 16-pixel blocks of random colours: a panel drawn a pixel
    off, or resampled otherwise, shows at every block edge."""
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, ((h + 15) // 16, (w + 15) // 16, 3), np.uint8)
    return np.repeat(np.repeat(small, 16, 0), 16, 1)[:h, :w]


@pytest.mark.parametrize("h,w", [(384, 512), (224, 224), (120, 300)])
def test_visualize_matching_pairs_matches_matplotlibs_panels(h, w, tmp_path):
    rng = np.random.RandomState(h)
    im1, im2 = _blocks(h, w, 1), _blocks(h, w, 2)
    kp1, kp2 = (np.stack([rng.uniform(0, w - 1, 40), rng.uniform(0, h - 1, 40)], -1)
                for _ in range(2))
    valid = rng.rand(40) > 0.2
    want = jvis.visualize_matching_pairs(im1, im2, kp1, kp2, 3, 4, str(tmp_path / "j"),
                                         valid=valid)
    got = tvis.visualize_matching_pairs(im1, im2, kp1, kp2, 3, 4, str(tmp_path / "t"),
                                        valid=valid)
    assert os.path.basename(got) == os.path.basename(want) == "match_epoch3_batch4.png"
    n, mean, far = _panel_diff(got, want)
    assert n > 0.3 * 500 * 1500 and mean <= 4.0 and far <= 0.02, (n, mean, far)


@pytest.mark.parametrize("h,w", [(384, 512), (224, 224), (120, 300)])
def test_visualize_depth_maps_matches_matplotlibs_panels(h, w, tmp_path):
    yy, xx = np.mgrid[0:h, 0:w]
    d1 = (np.floor(xx / 8) * 3 + np.floor(yy / 8)).astype(np.float32)  # blocks again
    d2 = (np.sin(xx / 17.0) + np.cos(yy / 11.0)).astype(np.float32)
    want = jvis.visualize_depth_maps(d1, d2, 5, 6, str(tmp_path / "j"))
    got = tvis.visualize_depth_maps(d1, d2, 5, 6, str(tmp_path / "t"))
    assert os.path.basename(got) == os.path.basename(want) == "depth_epoch5_batch6.png"
    n, mean, far = _panel_diff(got, want)
    assert n > 0.1 * 500 * 1500 and mean <= 4.0 and far <= 0.02, (n, mean, far)
