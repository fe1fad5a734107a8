"""The port's MASt3R side of pretraining against gd3d's on the CPU, at the
CLI's --tiny widths: the head's desc_conf (two_confs on and off), the
CroCo -> DUSt3R trunk handoff both ways, the Mast3r converters and .npz
trees, and a fresh Mast3r's heads against gd3d's Mast3rHead.init.

Tolerances: every Mast3r output 1e-5 of its largest value, except `desc`
at 1e-4: it is x / |x| over the --tiny net's 6 channels, so a pixel whose
6-vector is short carries its components' fp32 error divided by that
norm (measured 1.1e-5 on the handoff's inputs). Weights and files exact;
the init as in tests/test_torch_pretrain_model.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gd3d.cli.pretrain import _load_npz_tree, _merge_trunk, _save
from gd3d.models.croco_pretrain import croco_to_dust3r as jcroco_to_dust3r
from gd3d.models.mast3r import Mast3r as JMast3r
from gd3d.models.mast3r import Mast3rHead as JMast3rHead
from gd3d_torch.cli import pretrain as P
from gd3d_torch.convert import load_flat_npz, mast3r_params, mast3r_state_dict
from gd3d_torch.models.croco_pretrain import croco_to_dust3r
from gd3d_torch.models.mast3r import Mast3r
from tests.test_torch_pretrain_model import (
    IMG,
    TOL,
    cli_model,
    croco_pair,
    images,
    init_stats_match,
    jtree,
    mast3r_cfgs,
    rel,
    seeded,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DESC_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def japply(two_confs=True):
    return jax.jit(JMast3r(mast3r_cfgs(two_confs)[1]).apply)


def assert_outputs(got, want):
    for r in ("res1", "res2"):
        assert set(got[r]) == set(want[r])
        for k in want[r]:
            assert rel(got[r][k], want[r][k]) <= (DESC_TOL if k == "desc" else TOL), (r, k)


@pytest.mark.parametrize("two_confs", [True, False])
def test_mast3r_head_returns_gd3d_desc_conf(two_confs):
    cfg, _ = mast3r_cfgs(two_confs)
    model = seeded(Mast3r(cfg))
    img1, img2 = images()
    want = japply(two_confs)({"params": jtree(mast3r_params(model.state_dict()))}, img1, img2)
    with torch.no_grad():
        got = model(torch.from_numpy(img1), torch.from_numpy(img2))
    assert_outputs(got, want)
    if not two_confs:
        torch.testing.assert_close(got["res1"]["desc_conf"], got["res1"]["conf"], rtol=0, atol=0)


def test_mast3r_converters_and_npz_trees_round_trip(tmp_path):
    cfg, _ = mast3r_cfgs()
    model = seeded(Mast3r(cfg), 4)
    flat = mast3r_params(model.state_dict())
    P.save_params(tmp_path / "p.npz", model, "mast3r")
    tree = load_flat_npz(tmp_path / "p.npz")
    jt = _load_npz_tree(tmp_path / "p.npz")  # gd3d's reader of the port's file
    assert {"/".join(k) for k in flatten_dict(jt)} == set(flat)
    sd = mast3r_state_dict(tree, cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_croco_to_dust3r_handoff_matches_gd3d(tmp_path):
    """The port's trunk export loads into the port's Mast3r as gd3d's
    croco_to_dust3r merges into gd3d's: same forward. A trunk gd3d's CLI
    writes (its _save) loads through --init-trunk's reader, and the port's
    file through gd3d's _merge_trunk."""
    croco, _, cparams = croco_pair(2)
    cfg, _ = mast3r_cfgs()
    mast3r = seeded(Mast3r(cfg), 3)
    jparams = jtree(mast3r_params(mast3r.state_dict()))

    P.save_trunk(tmp_path / "port_trunk.npz", croco)
    _save(tmp_path / "gd3d_trunk.npz", jcroco_to_dust3r(cparams))
    with np.load(tmp_path / "port_trunk.npz") as a, np.load(tmp_path / "gd3d_trunk.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    P.load_trunk(mast3r, tmp_path / "gd3d_trunk.npz", cfg)
    trunk = croco_to_dust3r(croco.state_dict())
    own = mast3r.state_dict()
    for k, v in trunk.items():
        torch.testing.assert_close(own[k], v, rtol=0, atol=0)
    merged = _merge_trunk(jax.tree_util.tree_map(np.asarray, jparams),
                          _load_npz_tree(tmp_path / "port_trunk.npz"))
    img1, img2 = images(9)
    want = japply()({"params": jtree({"/".join(k): v for k, v in flatten_dict(merged).items()})},
                    img1, img2)
    with torch.no_grad():
        got = mast3r(torch.from_numpy(img1), torch.from_numpy(img2))
    assert_outputs(got, want)


def test_fresh_mast3r_heads_draw_flax_defaults():
    """The heads' layers (the DPT's convs and transposed convs, the local
    features' MLP) against gd3d's Mast3rHead.init; the trunk's layer kinds
    are the CroCo net's, held in tests/test_torch_pretrain_model.py."""
    _, jcfg = mast3r_cfgs()
    c = jcfg.croco
    gh = gw = IMG // c.patch_size
    enc, dec = (jnp.zeros((2, gh * gw, d), jnp.float32) for d in (c.enc_embed_dim,
                                                                  c.dec_embed_dim))
    init = jax.jit(JMast3rHead(jcfg).init, static_argnums=4)
    jhead = init(jax.random.key(0), [enc, dec, dec, dec], enc, dec, (gh, gw))["params"]
    model = cli_model("mast3r")
    flat = {k: v for k, v in mast3r_params(model.state_dict()).items() if k.startswith("head1/")}
    want = {"/".join(k): np.asarray(v, np.float64) for k, v in flatten_dict(jhead).items()}
    init_stats_match({k[len("head1/"):]: v for k, v in flat.items()}, want)
