"""The port's CroCo pretraining net against gd3d's on the CPU, at the
CLI's --tiny widths: CrocoPretrain's forward and masked MSE, the weight
converters, the --init-trunk refusal, and flax's default initialisers;
the MASt3R side (desc_conf, the trunk handoff) is
tests/test_torch_pretrain_mast3r_model.py.

Tolerances: forwards and losses 1e-5 of the largest value (fp32 sums in
another order); masks, targets and converted weights exact; a fresh
init's per-tensor mean and std within five standard errors of gd3d's
(each is a sample of the same distribution from another generator), its
zeros and ones exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.croco_pretrain import CrocoPretrain as JCrocoPretrain
from gd3d.models.croco_pretrain import masked_mse as jmasked_mse
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d_torch.cli import pretrain as P
from gd3d_torch.convert import (
    croco_pretrain_params,
    croco_pretrain_state_dict,
    unflatten,
)
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.croco_pretrain import CrocoPretrain, masked_mse, random_mask
from gd3d_torch.models.flax_init import flax_init_
from gd3d_torch.models.mast3r import Mast3r, Mast3rConfig
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
IMG = 64
MASK = 0.75


def rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want.astype(np.float64)).max(), 1e-12))


def mast3r_cfgs(two_confs=True):
    kw = dict(local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16, two_confs=two_confs)
    return (Mast3rConfig(croco=CrocoConfig(**P.TINY_CROCO), **kw),
            JMast3rConfig(croco=JCrocoConfig(**P.TINY_CROCO), **kw))


def images(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32) for _ in range(2))


def seeded(module, seed=0):
    flax_init_(module, torch.Generator().manual_seed(seed))
    return module


def jtree(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


@functools.lru_cache(maxsize=None)
def jcroco_apply():
    return jax.jit(JCrocoPretrain(JCrocoConfig(**P.TINY_CROCO), mask_ratio=MASK).apply)


def croco_pair(seed=0):
    """A seeded port CrocoPretrain, gd3d's jitted apply, the port's
    weights as gd3d's tree."""
    model = seeded(CrocoPretrain(CrocoConfig(**P.TINY_CROCO), mask_ratio=MASK), seed)
    return model, jcroco_apply(), jtree(croco_pretrain_params(model.state_dict()))


def test_random_mask_draws_exactly_the_ratio():
    m = random_mask(np.random.RandomState(3), 5, 196, 0.9)
    assert m.shape == (5, 196) and (m.sum(1) == int(0.9 * 196)).all()
    noise = np.random.RandomState(3).rand(5, 196)  # gd3d's CLI rule
    np.testing.assert_array_equal(m, np.argsort(noise, axis=1, kind="stable") < int(0.9 * 196))


@pytest.mark.parametrize("seed", [0, 1])
def test_croco_pretrain_forward_and_masked_mse(seed):
    model, japply, params = croco_pair(seed)
    img1, img2 = images(seed + 5)
    mask = random_mask(np.random.RandomState(seed), 2, (IMG // 16) ** 2, MASK)
    jpred, jtarget = japply({"params": params}, img1, img2, mask)
    pred, target = model(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(mask))
    assert rel(pred, jpred) <= TOL
    np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget))
    for norm_pix in (False, True):
        for masked in (True, False):
            want = jmasked_mse(jpred, mask, jtarget, norm_pix_loss=norm_pix, masked=masked)
            got = masked_mse(pred, torch.from_numpy(mask), target, norm_pix_loss=norm_pix,
                             masked=masked)
            assert rel(got, want) <= TOL, (norm_pix, masked)


def test_croco_pretrain_converters_round_trip():
    model, _, params = croco_pair()
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    sd = croco_pretrain_state_dict(params, CrocoConfig(**P.TINY_CROCO))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    back = croco_pretrain_params(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_init_trunk_refuses_another_config(tmp_path):
    croco, _, _ = croco_pair()
    P.save_trunk(tmp_path / "t.npz", croco)
    wide = Mast3rConfig(croco=CrocoConfig(**{**P.TINY_CROCO, "enc_embed_dim": 64}),
                        local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
    with pytest.raises(SystemExit):
        P.load_trunk(seeded(Mast3r(wide)), tmp_path / "t.npz", wide)


def init_stats_match(flat_t: dict, flat_j: dict):
    """Per tensor of two flat 'a/b/c' trees: zeros and ones exact, else mean
    and std within five standard errors of gd3d's draw."""
    assert set(flat_t) == set(flat_j)
    for k, want in flat_j.items():
        got = flat_t[k].astype(np.float64)
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        n, s = want.size, want.std()
        assert abs(got.mean() - want.mean()) <= 5 * s * np.sqrt(2.0 / n), k
        assert abs(got.std() - s) <= 5 * s * np.sqrt(1.0 / n), k
        assert np.abs(got).max() <= 2 * s / 0.87 * 1.2, k  # truncated at two stds


def cli_model(objective):
    args = P.parse_args(["--output", "unused", "--objective", objective, "--tiny", "--cpu",
                         "--img", str(IMG), "--mask-ratio", str(MASK)])
    return P.build_model(args, torch.device("cpu"))


def test_fresh_croco_init_draws_flax_defaults():
    img1, img2 = images()
    mask = random_mask(np.random.RandomState(0), 2, (IMG // 16) ** 2, MASK)
    jparams = jax.jit(JCrocoPretrain(JCrocoConfig(**P.TINY_CROCO), mask_ratio=MASK).init)(
        jax.random.key(0), img1, img2, mask)["params"]
    init_stats_match(croco_pretrain_params(cli_model("croco").state_dict()),
                     {"/".join(k): np.asarray(v, np.float64)
                      for k, v in flatten_dict(jparams).items()})
