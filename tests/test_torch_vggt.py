"""The port's VGGT modules against gd3d's, per module, at the TINY config of
tests/test_vggt.py, on shared weights (one seeded gd3d init with every leaf
perturbed, converted by vggt_state_dict, loaded strictly), fp32 on the CPU.

Tolerance: rtol 2e-3, atol 2e-4 on activations (fp32 models a few layers
deep, sums in another order; the existing torch-transcription tests of
gd3d's VGGT use 3e-3 / 3e-5 and 5e-3 / 5e-4); integer and boolean outputs
(masks, keypoints) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.models.vggt.aggregator import Aggregator as JAggregator
from gd3d.models.vggt.config import VggtConfig as JVggtConfig
from gd3d.models.vggt.dinov2 import DinoV2 as JDinoV2
from gd3d.models.vggt.heads import CameraHead as JCameraHead
from gd3d.models.vggt.heads import VggtDPTHead as JDPTHead
from gd3d.models.vggt.heads import pose_encoding_to_extri_intri as jpose_decode
from gd3d.models.vggt.heads import unproject_depth_to_world as junproject
from gd3d.models.vggt.layers import VggtBlock as JVggtBlock
from gd3d.models.vggt.model import Vggt as JVggt
from gd3d.models.vggt.track import TrackHead as JTrackHead
from gd3d.models.vggt.track import bilinear_sample_zero as jbilinear
from gd3d.ops.geometry import coview_masks as jcoview_masks
from gd3d.ops.nms import sample_keypoints_nms as jnms
from gd3d.teachers.vggt import VggtTeacher as JVggtTeacher
from gd3d_torch import convert
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.dinov2 import DinoV2
from gd3d_torch.models.vggt.heads import (
    pose_encoding_to_extri_intri,
    unproject_depth_to_world,
)
from gd3d_torch.models.vggt.layers import VggtBlock
from gd3d_torch.models.vggt.model import Vggt
from gd3d_torch.models.vggt.track import bilinear_sample_zero
from gd3d_torch.ops.geometry import coview_masks
from gd3d_torch.ops.nms import sample_keypoints_nms
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
               num_register_tokens=4, dino_depth=2, dino_num_heads=2, camera_trunk_depth=1,
               camera_iterations=2, dpt_features=8, dpt_out_channels=(8, 8, 8, 8),
               dpt_hooks=(0, 0, 1, 1), track_features=8, track_iters=2, track_stride=2,
               corr_levels=2, corr_radius=1, track_hidden_size=16, track_depth=2,
               num_virtual_tracks=4)
JTINY, TINY = JVggtConfig(**TINY_KW), VggtConfig(**TINY_KW)
TOL = dict(rtol=2e-3, atol=2e-4)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.02 * rng.randn(*np.shape(x))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models():
    params = _perturbed(JVggtTeacher(JTINY).init_params(jax.random.key(0), hw=(28, 28)), 0)
    model = Vggt(TINY)
    model.load_state_dict(convert.vggt_state_dict(params, TINY))  # strict: every key
    return params, model.eval()


def _imgs(seed=1, shape=(1, 2, 28, 28, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_state_dict_carries_weights(models):
    params, model = models
    sd = model.state_dict()
    blk = params["aggregator"]["aa_pairs"]["global"]
    np.testing.assert_array_equal(sd["aggregator.global_blocks.1.attn.qkv.weight"].numpy(),
                                  blk["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["aggregator.global_blocks.1.ls2.gamma"].numpy(),
                                  blk["ls2"]["gamma"][1])
    uf = params["track_head"]["tracker"]["updateformer"]
    np.testing.assert_array_equal(
        sd["track_head.tracker.updateformer.space_virtual2point_blocks.1.cross_attn."
           "in_proj_weight"].numpy(), uf["v2p_1"]["cross_attn"]["in_proj_weight"])
    np.testing.assert_array_equal(sd["track_head.tracker.updateformer.virual_tracks"].numpy(),
                                  uf["virtual_tracks"])
    assert float(sd["aggregator.patch_embed.mask_token"].abs().sum()) == 0.0


@pytest.mark.parametrize("img_size,hw", [(28, (28, 28)), (42, (28, 42))])
def test_dinov2(img_size, hw):
    """Also with the pos embed resized (3x3 -> 2x2 rows, an antialiased
    downscale, and 3 columns kept)."""
    kw = dict(TINY_KW, img_size=img_size)
    imgs = _imgs(2, (2, *hw, 3))
    jm = JDinoV2(JVggtConfig(**kw))
    params = _perturbed(jm.init(jax.random.key(3), jnp.asarray(imgs))["params"], 3)
    sd: dict = {}
    convert._vggt_dinov2(sd, "m", params, VggtConfig(**kw))
    m = DinoV2(VggtConfig(**kw))
    m.load_state_dict({k[2:]: v for k, v in convert._to_torch(sd).items()})
    close(m(torch.from_numpy(imgs)), jm.apply({"params": params}, jnp.asarray(imgs)))


def test_block_qk_norm_rope_and_export(models):
    params, model = models
    P = 9  # 5 special tokens + 2x2 patches, two frames
    rng = np.random.RandomState(4)
    x = rng.randn(1, 2 * P, 32).astype(np.float32)
    pos = np.concatenate([np.zeros((5, 2), np.int64),
                          np.stack(np.meshgrid(np.arange(2), np.arange(2), indexing="ij"),
                                   -1).reshape(4, 2) + 1], 0)
    gpos = np.tile(pos, (2, 1))[None]
    jb = JVggtBlock(32, 2, 4.0, 0.01, qk_norm=True, use_rope=True, eps=1e-5)
    bp = jax.tree_util.tree_map(lambda a: a[0], params["aggregator"]["aa_pairs"]["global"])
    want, wmap = jb.apply({"params": bp}, jnp.asarray(x), pos=jnp.asarray(gpos),
                          return_attn=True, temperature=0.8)
    blk = VggtBlock(32, 2, 4.0, 0.01, qk_norm=True, use_rope=True, eps=1e-5)
    blk.load_state_dict(model.aggregator.global_blocks[0].state_dict())
    got, gmap = blk(torch.from_numpy(x), pos=torch.from_numpy(gpos), return_attn=True,
                    temperature=0.8)
    close(got, want)
    close(gmap, wmap)


def test_aggregator_tokens_and_attn_mean(models):
    params, model = models
    imgs = _imgs(5)
    want, wattn = JAggregator(JTINY).apply({"params": params["aggregator"]}, jnp.asarray(imgs),
                                           temperature=0.9)
    got, gattn = model.aggregator(torch.from_numpy(imgs), temperature=0.9)
    for g, w in zip(got, want):
        close(g, w)
    close(gattn, wattn)
    np.testing.assert_allclose(gattn.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_camera_head_and_pose_decoding(models):
    params, model = models
    tokens = np.random.RandomState(6).randn(1, 2, 9, 64).astype(np.float32)
    want = JCameraHead(JTINY).apply({"params": params["camera_head"]}, jnp.asarray(tokens),
                                    num_iterations=2)
    got = model.camera_head(torch.from_numpy(tokens), 2)
    close(got, want)
    extr, intr = pose_encoding_to_extri_intri(got, (28, 42))
    jextr, jintr = jpose_decode(jnp.asarray(got.detach().numpy()), (28, 42))
    close(extr, jextr, rtol=1e-5, atol=1e-6)
    close(intr, jintr, rtol=1e-5, atol=1e-5)
    depth = np.random.RandomState(7).rand(1, 2, 28, 42).astype(np.float32) + 0.5
    world = unproject_depth_to_world(torch.from_numpy(depth), extr, intr)
    for s in range(2):
        close(world[0, s], junproject(jnp.asarray(depth[0, s]), jextr[0, s], jintr[0, s]),
              rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head,out,act", [("depth_head", 2, "exp"),
                                          ("point_head", 4, "inv_log")])
def test_dpt_heads(models, head, out, act):
    params, model = models
    rng = np.random.RandomState(8)
    tokens = [rng.randn(1, 2, 9, 64).astype(np.float32) for _ in range(2)]
    jm = JDPTHead(JTINY, output_dim=out, activation=act, conf_activation="expp1")
    wpts, wconf = jm.apply({"params": params[head]}, [jnp.asarray(t) for t in tokens], (28, 28))
    gpts, gconf = getattr(model, head)([torch.from_numpy(t) for t in tokens], (28, 28))
    close(gpts, wpts)
    close(gconf, wconf)


def test_bilinear_sample_zero_padding():
    img = np.random.RandomState(9).randn(5, 7).astype(np.float32)
    coords = np.array([[0.0, 0.0], [6.0, 4.0], [6.5, 2.25], [-0.5, 1.5], [3.3, 4.9],
                       [-1.2, -3.0], [7.0, 2.0]], np.float32)
    want = jbilinear(jnp.asarray(img), jnp.asarray(coords))
    got = bilinear_sample_zero(torch.from_numpy(img)[None], torch.from_numpy(coords)[None])[0]
    close(got, want, rtol=1e-6, atol=1e-6)


def test_track_head(models):
    params, model = models
    rng = np.random.RandomState(10)
    tokens = [rng.randn(1, 2, 9, 64).astype(np.float32) for _ in range(2)]
    qp = (rng.rand(1, 5, 2) * 27).astype(np.float32)
    wc, wv, wf = JTrackHead(JTINY).apply({"params": params["track_head"]},
                                         [jnp.asarray(t) for t in tokens], (28, 28),
                                         jnp.asarray(qp))
    gc, gv, gf = model.track_head([torch.from_numpy(t) for t in tokens], (28, 28),
                                  torch.from_numpy(qp))
    for g, w in zip(gc, wc):
        close(g, w)
    close(gv, wv)
    close(gf, wf)


def test_full_forward(models):
    params, model = models
    imgs = _imgs(11)
    qp = (np.random.RandomState(12).rand(1, 6, 2) * 27).astype(np.float32)
    want = JVggt(JTINY).apply({"params": params}, jnp.asarray(imgs), temperature=0.8,
                              query_points=jnp.asarray(qp), run_track=True)
    got = model(torch.from_numpy(imgs), temperature=0.8, query_points=torch.from_numpy(qp),
                run_track=True)
    for key in ("attn", "pose_enc", "depth", "depth_conf", "world_points",
                "world_points_conf", "track", "vis", "track_conf"):
        close(got[key], want[key], err_msg=key, **TOL)


def test_coview_masks_and_nms_with_injected_priority():
    rng = np.random.RandomState(13)
    H, W = 12, 16
    pm1 = (rng.rand(H, W, 3) * [2, 2, 1] + [-1, -1, 1.5]).astype(np.float32)
    pm2 = (rng.rand(H, W, 3) * [2, 2, 1] + [-1, -1, 1.5]).astype(np.float32)
    K = np.array([[10.0, 0, W / 2], [0, 10.0, H / 2], [0, 0, 1]], np.float32)
    E1 = np.concatenate([np.eye(3), [[0.0], [0.0], [0.25]]], 1).astype(np.float32)
    E2 = np.concatenate([np.eye(3), [[0.1], [0.0], [0.2]]], 1).astype(np.float32)
    jm1, jm2 = jcoview_masks(*map(jnp.asarray, (pm1, pm2, K, E1, K, E2)), (H, W))
    m1, m2 = coview_masks(*map(torch.from_numpy, (pm1, pm2, K, E1, K, E2)), (H, W))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jm2))
    assert 0 < int(m1.sum()) < H * W

    conf = rng.rand(H, W).astype(np.float32)
    key = jax.random.key(14)
    for num in (4, 40):  # fewer and more than the NMS survivors
        jk, jv = jnms(jm1, jnp.asarray(conf), num, 1, key)
        priority = torch.from_numpy(np.array(jax.random.uniform(key, (H * W,), jnp.float32)))
        k, v = sample_keypoints_nms(m1, torch.from_numpy(conf), num, 1, priority=priority)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
