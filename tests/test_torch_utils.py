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
    with pytest.raises(ValueError, match="cannot handle"):  # as Image.fromarray
        tmisc.resize_crop(np.ones((8, 8), np.int64))


def _framed(dtype, shape, lo, hi, seed):
    """A random image inside a zero frame (so getbbox has work), in dtype."""
    rng = np.random.RandomState(seed)
    a = np.zeros(shape, dtype)
    H, W = shape[:2]
    a[4:H - 6, 6:W - 8] = (rng.rand(H - 10, W - 14, *shape[2:]) * (hi - lo) + lo).astype(dtype)
    return a


# dtype, shape, value range: every array gd3d's Image.fromarray takes there
RESIZE_MODES = {
    "RGBA": ("u1", (40, 50, 4), 0, 255), "LA": ("u1", (40, 50, 2), 0, 255),
    "F": ("<f4", (40, 50), -3, 5), "F_from_float64": ("<f8", (40, 50), -3, 5),
    "I": ("<i4", (40, 50), -2e9, 2e9), "I_from_int16": ("<i2", (40, 50), -3e4, 3e4),
    "I_from_uint32": ("<u4", (40, 50), 0, 4e9), "I;16": ("<u2", (40, 50), 0, 65535),
    "I;16B": (">u2", (40, 50), 0, 65535), "1": ("?", (40, 50), 0, 2),
    "RGB": ("u1", (40, 50, 3), 0, 255), "L": ("u1", (40, 50), 0, 255),
}


@pytest.mark.parametrize("out_size", [17, 32, 80, 44])
@pytest.mark.parametrize("mode", sorted(RESIZE_MODES))
def test_resize_crop_matches_gd3d_in_every_mode(mode, out_size):
    """resize_crop against gd3d's (Image.fromarray, getbbox, crop, resize) in
    each mode: RGBA and LA premultiplied around the bicubic filter and
    their bounding box from alpha, F / I / I;16 in Pillow's 32- and 16-bit
    resamplers (I's sums past the int range as x86 converts them), 1 by
    NEAREST, and out_size 44 a plain copy (the crop is 44 wide, but for
    I;16, whose box Pillow scans byte-wise). Every mode
    bit for bit, F too (the bound is 0: the same float64 sums in the same
    order, rounded once to float32)."""
    dtype, shape, lo, hi = RESIZE_MODES[mode]
    img = _framed(dtype, shape, lo, hi, len(mode) + out_size)
    got, T = tmisc.resize_crop(img, out_size=out_size)
    want, T_want = jmisc.resize_crop(img, out_size=out_size)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and np.array_equal(T, T_want)


@pytest.mark.parametrize("dtype,shape", [("<i8", (8, 8)), ("u1", (8, 8, 1)), ("<f4", (8, 8, 3)),
                                         ("<i4", (8, 8, 2))])
def test_resize_crop_refuses_what_pillow_refuses(dtype, shape):
    with pytest.raises(TypeError):
        jmisc.resize_crop(np.ones(shape, dtype))
    with pytest.raises(ValueError, match="cannot handle"):
        tmisc.resize_crop(np.ones(shape, dtype))


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


# What the reader once refused (a case each) and the rest of yaml.safe_load:
# directives, document markers, anchors and aliases, merges, block
# scalars with their indicators, multi-line and escaped scalars, complex
# keys, the standard tags and timestamps
YAML_SAFE_LOAD = [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "a: >\n  t\n", "---\na: 1\n",
    "? a\n: b\n", "<<: {a: 1}\n", "a: 2001-12-14\n", "a: b\n  c\n", "a: 'x\n  y'\n",
    "%YAML 1.1\n%TAG !e! tag:yaml.org,2002:\n---\na: !e!int '12'\n...\n",
    "base: &b {x: 1, y: 2}\nd:\n  <<: *b\n  y: 3\n",
    "d:\n  <<: [{a: 1}, {a: 2, b: 3}]\n  c: 4\n",
    "a: |-\n  x\n\n  y\n\n\nb: |+\n  x\n\n\nc: >2\n   indented\n  more\n\n  para\n",
    "a: >-\n  folded\n  line\n\n  next\n   more indented\n  back\n",
    's: "esc \\x41 \\u00e9 \\U0001F600 \\N \\_ \\L \\P \\e \\0 \\/ \\t \\a \\b \\v \\f"\n',
    's: "multi\n  line\n\n  para \\\n  cont"\nt: \'it\'\'s\n\n  two\'\n',
    "plain: this is\n  a multi line\n\n  plain\n",
    "? a b\n: c\n? |\n  block key\n: v\n? >\n  folded\n  key\n: w\n? !!binary aGk=\n: x\n",
    "[a: 1, b]\n", "{a, b: 1, ? c}\n",
    "- &a [1, 2]\n- *a\n",
    "s: !!set {a, b}\no: !!omap [a: 1, b: 2]\np: !!pairs [a: 1, a: 2]\nb: !!binary aGVsbG8=\n",
    "a: !!float 1\nb: !!int '0x1F'\nc: !!bool YES\nd: !!null x\ne: !!seq [1]\nf: !!map {a: 1}\n",
    "t: 2001-12-14t21:59:43.10-05:00\nu: 2001-12-14 21:59:43.10\nv: 2001-12-15T02:59:43.1Z\n"
    "w: 2002-12-14\nx: !!timestamp 2001-12-14\n",
    "--- |\n  doc\n", "a: ! 12\nb: ! '12'\nc: !<tag:yaml.org,2002:str> 12\n",
]


@pytest.mark.parametrize("i", range(len(YAML_SAFE_LOAD)))
def test_yaml_reader_matches_safe_load(i):
    """Every construct of yaml.safe_load, the same repr (types, values, key
    order, dates and datetimes with their time zones)."""
    text = YAML_SAFE_LOAD[i]
    assert repr(loads(text)) == repr(yaml.safe_load(text))


def test_yaml_aliases_give_the_same_object():
    """An alias is its anchor's object, as PyYAML builds it, also inside
    itself."""
    got = loads("a: &x [1, {b: 2}]\nc: *x\nd: &y [*y]\n")
    assert got["a"] is got["c"] and got["d"][0] is got["d"]


def _shared_tree(draw_leaf, children):
    """Random nested lists and dicts whose containers may appear more than
    once, so that the dumpers write anchors and aliases."""
    from hypothesis import strategies as st

    @st.composite
    def tree(draw):
        pool = []

        def node(depth):
            if depth == 0 or draw(st.integers(0, 3)) == 0:
                return draw(draw_leaf)
            if pool and draw(st.integers(0, 4)) == 0:
                return draw(st.sampled_from(pool))
            n = draw(st.integers(0, children))
            if draw(st.booleans()):
                value = [node(depth - 1) for _ in range(n)]
            else:
                value = {draw(draw_leaf): node(depth - 1) for _ in range(n)}
            pool.append(value)
            return value

        return node(4)

    return tree()


def _yaml_leaves():
    from hypothesis import strategies as st

    text = st.text(alphabet=st.sampled_from(list("ab :#-'\"\n\t\\é{}[],&*!|>%@`?~09.")),
                   max_size=12)
    return st.one_of(st.integers(-10 ** 9, 10 ** 9), st.floats(allow_nan=False), st.booleans(),
                     st.none(), text, st.dates(), st.binary(max_size=8),
                     st.sampled_from(["yes", "no", "on", "1:20", "0x1f", "017", "=", "<<", "~",
                                      "2001-01-01", ".inf", "", " x ", "a\n\nb"]))


@pytest.mark.parametrize("canonical", [False, True], ids=["safe_dump", "canonical"])
def test_yaml_reader_matches_safe_load_on_dumped_data(canonical):
    """yaml.safe_dump (anchors and aliases for shared containers, block and
    flow styles, folded long lines) and yaml.dump(canonical=True) (explicit
    tags and ---) of random nested data, read back as safe_load reads it."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(_shared_tree(_yaml_leaves(), 4), st.sampled_from([None, True, False]),
           st.sampled_from([20, 80]), st.sampled_from([None, '"', "'", "|", ">"]))
    def check(data, flow, width, style):
        if canonical:
            text = yaml.dump(data, Dumper=yaml.SafeDumper, canonical=True)
        else:
            text = yaml.safe_dump(data, default_flow_style=flow, width=width,
                                  default_style=style, allow_unicode=True)
        assert repr(loads(text)) == repr(yaml.safe_load(text))

    check()


@pytest.mark.parametrize("text,what", [
    ("a:\n\t- x\n", "tab"), ("a: [1, 2\n", "unclosed"),
    ("---\na: 1\n---\nb: 2\n", "second document"), ("a: !local x\n", "'!local'"),
    ("a: !!foo x\n", "'tag:yaml.org,2002:foo'"), ("{[1]: 2}\n", "unhashable key"),
])
def test_yaml_reader_refuses_by_name(text, what):
    """Where yaml.safe_load raises, the reader raises a ValueError naming the
    line and what it cannot read."""
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match=f"line [0-9]+: cannot read.*{what}"):
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
