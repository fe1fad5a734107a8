"""TSDF depth-map refinement for globally-aligned scenes (counterpart of
gd3d/tsdf.py: MASt3R's TSDFPostProcess, mast3r/cloud_opt/tsdf_optimizer.py).

For every pixel, sample candidate depths along its ray, evaluate a
multi-view truncated signed-distance function (reproject each candidate
into every view; SDF = that view's depth at the nearest pixel minus the
candidate's projected depth, truncated at the threshold, averaged over the
views by confidence) and keep the candidate whose TSDF is closest to zero.
Images run one after another and the queries of an image in fixed-size
chunks (gd3d's chunk=16384), on the scene's device; each query's value
depends on no other, so the chunk size changes no result.

As in gd3d, the confidence weights are the aligner's raw confidence maps
(the reference exps its log-confs, a monotone reweighting). The candidate
offsets are standard normal draws from `offset_draw`, a torch.Generator
per image and iteration; gd3d draws with jax.random (a key per image, folded
in per iteration), whose numbers torch cannot make, and its tests replace
`offset_draw` to feed gd3d's draws in.
"""
from __future__ import annotations

from typing import Dict

import torch

from gd3d_torch.align import Scene, _image_conf, _pixel_grid, rotate
from gd3d_torch.teachers.mast3r import no_tf32


def offset_draw(shape, seed: int, image: int, it: int, device) -> torch.Tensor:
    """Standard normal fp32 draws for image `image`'s iteration `it`."""
    g = torch.Generator(device=device).manual_seed((seed + image) * 1_000_003 + it)
    return torch.randn(shape, generator=g, device=device)


@torch.no_grad()
def tsdf_refine(
    scene: Scene,
    out: Dict[str, torch.Tensor],
    thresh: float,
    nsamples: int = 128,
    niter: int = 1,
    seed: int = 0,
    chunk: int = 16384,
) -> Dict[str, torch.Tensor]:
    """Refine the depthmaps of a `global_align` result with TSDF fusion.

    scene: the dense Scene the aligner ran on (conf maps for weighting).
    out: global_align(...)'s output (poses, focals, principal_points,
      depthmaps; tensors or arrays).
    thresh: TSDF truncation (the reference's TSDF_thresh; ~ the depth noise
      scale). Returns a new dict with refined `depthmaps` and recomputed
      `pts3d`, on the scene's device."""
    assert scene.pix is None, "tsdf_refine needs dense depth maps"
    H, W = scene.hw
    n = scene.n_imgs
    P = H * W
    dev = scene.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    poses = t(out["poses"])                                  # cam2world
    focals = t(out["focals"])
    pp = t(out["principal_points"])
    depth0 = t(out["depthmaps"]).reshape(n, P)
    conf = t(_image_conf(scene))                             # (n, P)
    Rt = poses[:, :3, :3].transpose(1, 2)                    # world -> cam
    w2c_t = -rotate(Rt, poses[:, None, :3, 3])[:, 0]
    pix = _pixel_grid(scene.hw, dev)

    def tsdf_query(q, curthresh):
        """q (M, 3) world points -> (TSDF value, valid) per point
        (tsdf_optimizer.py:85-110)."""
        cam = rotate(Rt, q[None].expand(n, -1, -1)) + w2c_t[:, None]
        z = cam[..., 2]                                      # (n, M)
        zsafe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
        u = torch.round(cam[..., 0] / zsafe * focals[:, None] + pp[:, 0:1])
        v = torch.round(cam[..., 1] / zsafe * focals[:, None] + pp[:, 1:2])
        inb = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        lin = (torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)).long()
        pred_d = torch.gather(depth0, 1, lin)
        pred_c = torch.gather(conf, 1, lin)
        sdf = pred_d - z
        unseen = sdf < -curthresh
        tsdf = torch.clamp(sdf, -curthresh, 1e20)
        w = torch.where(inb & ~unseen, pred_c, torch.zeros_like(pred_c))
        wsum = torch.sum(w, dim=0)
        valid = wsum > 0
        val = torch.sum(w * tsdf, dim=0) / torch.clamp(wsum, min=1e-12)
        return val, valid

    refined = []
    with no_tf32():
        for i in range(n):
            d, f_i, pp_i, pose_i = depth0[i], focals[i], pp[i], poses[i]
            for it in range(niter):
                curthresh = (niter - it) * thresh
                off = (offset_draw((P, nsamples), seed, i, it, dev) - 1.0) * curthresh
                cand = d[:, None] + off                      # (P, S)
                rel = torch.cat([cand[..., None] * ((pix - pp_i) / f_i)[:, None, :],
                                 cand[..., None]], dim=-1)   # (P, S, 3)
                world = rotate(pose_i[None, :3, :3], rel.reshape(1, -1, 3))[0] + pose_i[:3, 3]
                parts = [tsdf_query(world[s:s + chunk], curthresh)
                         for s in range(0, world.shape[0], chunk)]
                vals = torch.cat([p[0] for p in parts]).reshape(P, nsamples)
                valids = torch.cat([p[1] for p in parts]).reshape(P, nsamples)

                avals = torch.where(valids, torch.abs(vals), torch.full_like(vals, torch.inf))
                best = torch.argmin(avals, dim=-1)
                # flat zone: every sample clipped to the truncation value
                allbad = torch.sum((torch.abs(vals) == curthresh).int(), dim=-1) == nsamples
                d_new = torch.gather(cand, 1, best[:, None])[:, 0]
                d = torch.where(allbad, d, d_new)
            refined.append(d)
        refined = torch.stack(refined)

        # world points from the refined depths
        R, tr = poses[:, :3, :3], poses[:, :3, 3]
        rel = torch.cat([refined[..., None] * ((pix[None] - pp[:, None]) / focals[:, None, None]),
                         refined[..., None]], dim=-1)
        world = rotate(R, rel) + tr[:, None]
    res = dict(out)
    res["depthmaps"] = refined.reshape(n, H, W)
    res["pts3d"] = world.reshape(n, H, W, 3)
    return res
