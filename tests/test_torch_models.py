"""gd3d_torch models against gd3d on shared weights, fp32 on the CPU.

One seeded gd3d init is converted with gd3d_torch.convert and loaded into
the port; inputs come from numpy. The LoRA B matrices are set non-zero so
the LoRA path is exercised. Tolerance 1e-4 (relative and absolute): a
model composes many fp32 ops whose sums run in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.models.student import Student as JStudent
from gd3d.models.student import split_params as jsplit_params
from gd3d.models.vit import resample_pos_embed as jresample
from gd3d.teachers.convert import convert_timm_vit
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d.teachers.mast3r import convert_mast3r
from gd3d_torch.convert import mast3r_state_dict, student_state_dict, vit_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3r, Mast3rConfig
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.models.vit import ViT, init_params_, resample_pos_embed
from gd3d_torch.teachers.mast3r import Mast3rTeacher

TOL = dict(rtol=1e-4, atol=1e-4)
STUDENT_KW = dict(embed_dim=32, depth=8, num_heads=2, patch_size=16, pretrain_img_size=32,
                  lora_start_block=4, use_adapters=True, adapter_bottleneck=8,
                  target_res=64, downsample_factor=8, depth_head_hidden=16)
CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def with_nonzero_lora(params, seed=0):
    """gd3d zero-inits LoRA B; give it values so the LoRA path matters."""
    rng = np.random.RandomState(seed)
    attn = params["vit"]["blocks_adapt"]["attn"]
    for name in ("lora_b_q", "lora_b_v"):
        k = attn[name]["kernel"]
        attn[name]["kernel"] = (0.1 * rng.randn(*k.shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def students():
    jcfg = JStudentConfig(**STUDENT_KW)
    jst = JStudent(jcfg)
    params = with_nonzero_lora(_np_tree(jst.init(jax.random.key(0), img_size=32)))
    cfg = StudentConfig(**STUDENT_KW)
    st = Student(cfg)
    st.load_state_dict(student_state_dict(params, cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jst, jparams, st


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **{**TOL, **kw})


def test_resample_pos_embed():
    pe = np.random.RandomState(1).randn(1, 24 * 24 + 1, 8).astype(np.float32)
    for grid in ((52, 80), (21, 32), (24, 24)):
        close(resample_pos_embed(torch.from_numpy(pe), grid),
              jresample(jnp.asarray(pe), grid), rtol=1e-5, atol=1e-5)


def test_vit_tokens_and_intermediates(students):
    jst, jparams, st = students
    imgs = np.random.RandomState(2).randn(2, 48, 64, 3).astype(np.float32)
    want = jst.forward_tokens(jparams, jnp.asarray(imgs), take_indices=(1, 5, 7))
    got = st.forward_tokens(torch.from_numpy(imgs), take_indices=(1, 5, 7))
    close(got["tokens"], want["tokens"])
    for a, b in zip(got["intermediates"], want["intermediates"]):
        close(a, b)
    # tapping only intermediates truncates the trunk without changing them
    got_cut = st.forward_tokens(torch.from_numpy(imgs), take_indices=(5,),
                                final_tokens=False)
    assert "tokens" not in got_cut
    close(got_cut["intermediates"][0], want["intermediates"][1])


def test_student_feature_apis(students):
    jst, jparams, st = students
    rng = np.random.RandomState(3)
    rgbs = rng.rand(2, 64, 96, 3).astype(np.float32)
    pts = rng.uniform(0, 95, size=(2, 10, 2)).astype(np.float32)
    want_desc, want_kp = jst.get_feature_and_intermediates(
        jparams, jnp.asarray(rgbs), jnp.asarray(pts))
    desc, kp_feat = st.get_feature_and_intermediates(torch.from_numpy(rgbs),
                                                     torch.from_numpy(pts))
    close(desc, want_desc)
    close(kp_feat, want_kp)
    close(st.get_feature_cost(torch.from_numpy(rgbs)),
          jst.get_feature_cost(jparams, jnp.asarray(rgbs), normalize=False))


def test_depth_head_and_intra_depth_loss(students):
    jst, jparams, st = students
    rng = np.random.RandomState(4)
    feats = rng.randn(4, 12, 32).astype(np.float32)
    depths = rng.uniform(0.5, 2.0, size=(4, 12)).astype(np.float32)
    valid = rng.rand(4, 12) > 0.2
    close(st.depth_diff(torch.from_numpy(feats)), jst.depth_diff(jparams, jnp.asarray(feats)))
    close(st.pairwise_score_diff(torch.from_numpy(feats)),
          jst.pairwise_score_diff(jparams, jnp.asarray(feats)))
    got = st.intra_depth_loss(torch.from_numpy(feats), torch.from_numpy(depths),
                              torch.from_numpy(valid), 0.05)
    want = jst.intra_depth_loss(jparams, jnp.asarray(feats), jnp.asarray(depths),
                                jnp.asarray(valid), 0.05)
    assert float(want) > 0.0
    close(got, want)


def test_split_params_matches_gd3d(students):
    jst, jparams, st = students
    trainable, frozen = split_params(st)
    jt, jf = jsplit_params(jparams)
    size = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))  # noqa: E731
    assert sum(p.numel() for p in trainable.values()) == size(jt)
    assert sum(p.numel() for p in frozen.values()) == size(jf)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())


def test_timm_vit_round_trip():
    """Random port ViT -> timm-layout state dict -> gd3d convert_timm_vit ->
    gd3d_torch vit_state_dict: identical. Pins the key layout."""
    cfg = StudentConfig(**STUDENT_KW)
    vit = ViT(cfg)
    init_params_(vit, torch.Generator().manual_seed(5))
    timm_sd = {k: v for k, v in vit.state_dict().items()
               if "lora_" not in k and "adapter" not in k}
    tree = convert_timm_vit({k: v.numpy() for k, v in timm_sd.items()},
                            JStudentConfig(**STUDENT_KW))
    back = vit_state_dict(tree, cfg)
    assert back.keys() == timm_sd.keys()
    for k in timm_sd:
        assert torch.equal(back[k], timm_sd[k]), k


def test_mast3r_round_trip():
    """Random port MASt3R -> naver-layout state dict -> gd3d convert_mast3r
    -> gd3d_torch mast3r_state_dict: identical, ConvTranspose flips included."""
    cfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    model = Mast3r(cfg)
    init_params_(model, torch.Generator().manual_seed(6))
    sd = model.state_dict()
    tree = convert_mast3r({k: v.numpy() for k, v in sd.items()},
                          JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    back = mast3r_state_dict(tree, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_mast3r_extract_features():
    jcfg = JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW)
    jt = JMast3rTeacher(jcfg)
    params = jt.init_params(jax.random.key(1), hw=(64, 96))
    cfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    teacher = Mast3rTeacher(cfg)
    teacher.model.load_state_dict(mast3r_state_dict(_np_tree(params), cfg))
    rng = np.random.RandomState(7)
    img1 = (rng.rand(1, 64, 96, 3) * 2 - 1).astype(np.float32)
    img2 = (rng.rand(1, 64, 96, 3) * 2 - 1).astype(np.float32)
    want = jax.jit(lambda p, a, b: jt.extract_features(p, a, b, 0.7))(
        params, jnp.asarray(img1), jnp.asarray(img2))
    got = teacher.extract_features(torch.from_numpy(img1), torch.from_numpy(img2), 0.7)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        close(got[k], want[k])


def test_teacher_runs_without_tf32():
    """The teacher decides its own precision: TF32 is off inside its
    forward whatever the caller set, and the caller's switches come back."""
    teacher = Mast3rTeacher(Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW))
    seen = []
    teacher.model.register_forward_pre_hook(lambda m, a: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    precision, conv = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        img = torch.zeros((1, 64, 96, 3))
        teacher.extract_features(img, img)
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = conv
