"""Two-view pretraining (counterpart of gd3d/cli/pretrain.py): CroCo's masked
cross-view completion (`--objective croco`) and the MASt3R objective,
ConfLoss(Regr3D) + ConfMatchingLoss (`--objective mast3r`, the default).

    python -m gd3d_torch.cli.pretrain --output runs/croco --objective croco \\
        --export-dust3r --batch 16 --steps 100
    python -m gd3d_torch.cli.pretrain --output runs/mast3r \\
        --init-trunk runs/croco/dust3r_trunk.npz --img 512 --batch 2
    python -m gd3d_torch.cli.pretrain --output runs/tiny --tiny --device cpu

The flags are gd3d's. The pairs come from the in-process procedural
renderer, an on-disk render tree (--data-root) or one of nine stereo-view
datasets (--co3d-root ... --habitat-root). The nets run at full width
(CroCo v2 ViT-L/16 encoder with the Base decoder; Mast3rConfig()) unless
--tiny, and on the card unless --device cpu (or gd3d's --cpu) says
otherwise; --device cuda raises with no card. A fresh model draws flax's
default initialisers (models/flax_init.py) from torch.Generator(--seed).

Outputs under --output: metrics.jsonl (gd3d's keys, rounded to 5 digits;
`lr` with --warmup), params_final.npz and, with --ckpt-every N,
params_%06d.npz as gd3d's flattened param trees (so either package loads
the other's), state_last.npz (the parameters, AdamW's moments and count,
and the step: --resume continues a run exactly), and with
`--objective croco --export-dust3r` dust3r_trunk.npz, the trunk in gd3d's
Mast3r layout, which --init-trunk reads (from either package).

--mesh N trains data-parallel in N processes (torchrun, WORLD_SIZE = N;
NCCL on the card, gloo on the CPU): each rank takes its rows of the global
batch, the ranks' gradients are summed before the clip, and rank 0 writes
the outputs (distill/pretrain.py).

`main(argv, croco=None, on_start=None)` returns a dict with the model, the
optimizer, the step function, the batch maker, the step records and each
step's seconds; `croco` replaces the trunk's CrocoConfig (the callers' small
models), and `on_start(model, device_batch)` is called once the model holds
its starting weights (fresh, --init-trunk or --resume), before the first
step (the callers' random-weight set-ups and checks).
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path

import numpy as np

TINY_CROCO = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                  dec_embed_dim=16, dec_depth=2, dec_num_heads=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Pretrain a Mast3r two-view model (regression + matching objective) "
                    "or a CroCo net (masked cross-view completion)")
    p.add_argument("--output", required=True)
    p.add_argument("--objective", choices=("mast3r", "croco"), default="mast3r")
    p.add_argument("--mask-ratio", type=float, default=0.9,
                   help="croco objective: fraction of img1 patches masked")
    p.add_argument("--norm-pix-loss", action="store_true",
                   help="croco objective: per-patch pixel normalization of the target")
    p.add_argument("--export-dust3r", action="store_true",
                   help="croco objective: also write the trunk in the Mast3r layout "
                        "(dust3r_trunk.npz)")
    p.add_argument("--init-trunk", default=None, metavar="TRUNK_NPZ",
                   help="mast3r objective: initialise the encoder / decoder trunk from a "
                        "dust3r_trunk.npz; the heads stay freshly initialised")
    p.add_argument("--data-root", default=None, metavar="RENDER_TREE",
                   help="an on-disk render tree (color_/depth_/mask_%%06d.png + "
                        "obj_poses.npy) instead of procedural pairs")
    p.add_argument("--co3d-root", default=None, metavar="CO3D_DIR")
    p.add_argument("--wildrgbd-root", default=None, metavar="WRGBD_DIR")
    p.add_argument("--scannetpp-root", default=None, metavar="SNPP_DIR")
    p.add_argument("--arkit-root", default=None, metavar="ARKIT_DIR")
    p.add_argument("--blendedmvs-root", default=None, metavar="BMVS_DIR")
    p.add_argument("--megadepth-root", default=None, metavar="MD_DIR")
    p.add_argument("--staticthings-root", default=None, metavar="ST3D_DIR")
    p.add_argument("--waymo-root", default=None, metavar="WAYMO_DIR")
    p.add_argument("--habitat-root", default=None, metavar="HAB_DIR")
    p.add_argument("--habitat-size", type=int, default=1_000_000)
    p.add_argument("--co3d-split", default="train",
                   help="dataset split of the stereo-view datasets (default train)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--img", type=int, default=224)
    p.add_argument("--corres", type=int, default=256, help="padded correspondences per pair")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=0, metavar="N",
                   help="linear warmup over N steps, then cosine decay to 0 at --steps; "
                        "0 = constant LR")
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--matching-weight", type=float, default=0.075)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel processes (torchrun WORLD_SIZE; 0 = one process); "
                        "--batch must divide by it")
    p.add_argument("--tiny", action="store_true", help="tiny model and shapes (CPU only)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--cpu", action="store_true", help="gd3d's spelling of --device cpu")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save params every N steps (0 = final only), with state_last.npz")
    p.add_argument("--resume", default=None, metavar="STATE_NPZ",
                   help="resume from a state_last.npz (metrics.jsonl is appended)")
    return p.parse_args(argv)


def model_config(args, croco=None):
    """(CrocoConfig, Mast3rConfig or None) of the flags."""
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.mast3r import Mast3rConfig

    if croco is None:
        croco = CrocoConfig(**TINY_CROCO) if args.tiny else CrocoConfig()
    if args.objective == "croco":
        return croco, None
    if args.tiny:
        return croco, Mast3rConfig(croco=croco, local_feat_dim=6, dpt_feature_dim=32,
                                   dpt_last_dim=16)
    return croco, Mast3rConfig(croco=croco)


def build_model(args, device, croco=None):
    """The objective's net on `device`, flax's initialisers drawn from
    torch.Generator(device).manual_seed(--seed)."""
    import torch

    from gd3d_torch.models.croco_pretrain import CrocoPretrain
    from gd3d_torch.models.flax_init import flax_init_
    from gd3d_torch.models.mast3r import Mast3r

    ccfg, mcfg = model_config(args, croco)
    with device:
        model = CrocoPretrain(ccfg, mask_ratio=args.mask_ratio) if mcfg is None else Mast3r(mcfg)
    flax_init_(model, torch.Generator(device=device).manual_seed(args.seed))
    return model


def base_batch_fn(args):
    """seed, batch, img, corres -> a dense-GT pair batch (numpy), from the
    flags' data source."""
    from gd3d_torch.data import stereo_views as sv
    from gd3d_torch.data.pretrain_pairs import rendered_pretrain_batch, synthetic_pretrain_batch

    view_specs = [
        (args.co3d_root, sv.Co3dViews, args.co3d_split),
        (args.wildrgbd_root, sv.WildRGBDViews, args.co3d_split),
        (args.scannetpp_root, sv.ScanNetppViews, "train"),
        (args.arkit_root, sv.ARKitScenesViews, args.co3d_split),
        (args.blendedmvs_root, sv.BlendedMVSViews, args.co3d_split),
        (args.megadepth_root, sv.MegaDepthViews, args.co3d_split),
        (args.staticthings_root, sv.StaticThings3DViews, None),
        (args.waymo_root, sv.WaymoViews, None),
        (args.habitat_root, functools.partial(sv.HabitatViews, size=args.habitat_size),
         args.co3d_split),
    ]
    view_specs = [(r, c, s) for r, c, s in view_specs if r]
    if len(view_specs) > 1 or (view_specs and args.data_root):
        raise SystemExit("the --*-root dataset flags and --data-root are mutually exclusive")
    if view_specs:
        # StereoViews keeps the reference's `if self.seed:` quirk: only the
        # falsy default is remapped, so --seed 0 still crops reproducibly
        views_seed = args.seed if args.seed else args.seed + 1
        root, cls, split = view_specs[0]
        views = cls(root, split=split, resolution=(args.img, args.img), seed=views_seed)

        def base_batch(seed, batch_size, img, corres):
            rng = np.random.RandomState(seed)
            idxs = rng.randint(0, len(views), batch_size)
            return sv.views_pretrain_batch(views, idxs, rng, n_corres=corres)

        return base_batch
    if args.data_root:
        return functools.partial(rendered_pretrain_batch, args.data_root)
    return synthetic_pretrain_batch


def make_batch_fn(args, patch_size: int):
    """seed -> the objective's host batch (numpy) for step inputs."""
    from gd3d_torch.models.croco_pretrain import random_mask

    base_batch = base_batch_fn(args)
    if args.objective != "croco":
        return lambda seed: base_batch(seed, args.batch, args.img, args.corres)
    n_patches = (args.img // patch_size) ** 2

    def make_batch(seed):
        b = base_batch(seed, args.batch, args.img, args.corres)
        mask1 = random_mask(np.random.RandomState(seed), args.batch, n_patches, args.mask_ratio)
        return {"img1": b["img1"], "img2": b["img2"], "mask1": mask1}

    return make_batch


def to_device(batch, device):
    """A (nested) numpy batch -> tensors on `device`: floats as float32,
    integers as int64, masks as bool."""
    import torch

    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    a = np.asarray(batch)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard(batch, dp):
    """This rank's rows of a (nested) host batch."""
    from gd3d_torch.core.mesh import shard_batch

    return {k: shard(v, dp) if isinstance(v, dict) else shard_batch({k: v}, dp)[k]
            for k, v in batch.items()}


def save_params(path, model, objective: str) -> None:
    """The model's weights as gd3d's flattened param tree."""
    from gd3d_torch.convert import croco_pretrain_params, mast3r_params

    to_flat = croco_pretrain_params if objective == "croco" else mast3r_params
    np.savez(path, **to_flat(model.state_dict()))


def save_trunk(path, model) -> None:
    """A CrocoPretrain's trunk in gd3d's Mast3r layout (dust3r_trunk.npz)."""
    from gd3d_torch.convert import mast3r_params
    from gd3d_torch.models.croco_pretrain import croco_to_dust3r

    np.savez(path, **mast3r_params(croco_to_dust3r(model.state_dict())))


def load_trunk(model, path, cfg) -> None:
    """Overwrite a Mast3r's trunk with a dust3r_trunk.npz (written by this
    port or by gd3d); the heads keep their fresh init."""
    import torch

    from gd3d_torch.convert import load_flat_npz, mast3r_trunk_state_dict

    tree = load_flat_npz(path)
    own = model.state_dict()
    try:
        trunk = mast3r_trunk_state_dict(tree, cfg)
    except (KeyError, IndexError) as e:
        raise SystemExit(f"{path} is not a Mast3r trunk of this config ({e!r})") from e
    for k, v in trunk.items():
        if k not in own:
            raise SystemExit(f"trunk key {k} not in the model: was the trunk exported at "
                             "a different config?")
        if own[k].shape != v.shape:
            raise SystemExit(f"trunk shape mismatch at {k}: model {tuple(own[k].shape)} vs "
                             f"trunk {tuple(v.shape)}: match the --tiny/--img flags used "
                             "at export")
    with torch.no_grad():
        for k, v in trunk.items():
            own[k].copy_(v)


def save_state(path, model, optimizer, step: int) -> None:
    """The full restart state: parameters, AdamW's moments and count, and
    the step."""
    arrays = {f"param/{k}": v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    arrays.update({k: v.detach().cpu().numpy() for k, v in optimizer.state_dict().items()})
    np.savez(path, step=np.int64(step), **arrays)


def load_state(path, model, optimizer) -> int:
    import torch

    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    want = {f"param/{k}" for k in model.state_dict()} | set(optimizer.state_dict()) | {"step"}
    if set(stored) != want:
        raise ValueError(f"state layout mismatch: {path} does not hold this model and "
                         "optimizer; resume with the --tiny/--objective flags it was saved with")
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(torch.from_numpy(stored[f"param/{k}"]))
    optimizer.load_state_dict(stored)
    return int(stored["step"])


def main(argv=None, croco=None, on_start=None) -> dict:
    args = parse_args(argv)
    import torch

    from gd3d_torch.cli.align import resolve_device
    from gd3d_torch.core.mesh import init_distributed, local_device
    from gd3d_torch.distill.pretrain import (
        PretrainOptimizer,
        build_croco_pretrain_step,
        build_mast3r_pretrain_step,
    )
    from gd3d_torch.stereoflow import warmup_cosine_lr

    device = resolve_device("cpu" if args.cpu else args.device)
    dp = None
    if args.mesh:
        if args.batch % args.mesh:
            raise SystemExit(f"--batch {args.batch} not divisible by --mesh {args.mesh}")
        device = local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dp = init_distributed(device)
        if dp.world != args.mesh:
            raise SystemExit(f"--mesh {args.mesh} runs under torchrun with WORLD_SIZE "
                             f"{args.mesh}, got {dp.world}")
    main_rank = dp is None or dp.is_main

    # clamp before any dataset is built: a stereo-view dataset bakes the
    # resolution in
    if args.tiny:
        args.img = min(args.img, 64)
    if args.init_trunk and args.objective != "mast3r":
        raise SystemExit("--init-trunk applies to the mast3r objective (it reads what "
                         "--objective croco --export-dust3r writes)")
    ccfg, mcfg = model_config(args, croco)
    make_batch = make_batch_fn(args, ccfg.patch_size)
    model = build_model(args, device, croco)
    if args.init_trunk:
        load_trunk(model, args.init_trunk, mcfg)
        if main_rank:
            print(f"trunk initialized from {args.init_trunk}")
    if args.warmup:
        # optax counts decay_steps from step 0 and needs it past the warmup
        decay = max(args.steps, args.warmup + 1)
        lr = functools.partial(warmup_cosine_lr, peak=args.lr, warmup_steps=args.warmup,
                               decay_steps=decay)
    else:
        lr = lambda count: args.lr  # noqa: E731
    optimizer = PretrainOptimizer(model, lr, args.grad_clip, dp)

    start_step = 0
    if args.resume:
        start_step = load_state(args.resume, model, optimizer)
        if main_rank:
            print(f"resumed from {args.resume} at step {start_step}")
    if args.objective == "croco":
        step = build_croco_pretrain_step(model, optimizer, norm_pix_loss=args.norm_pix_loss,
                                         dp=dp)
    else:
        step = build_mast3r_pretrain_step(
            model, optimizer, loss_kwargs={"matching_weight": args.matching_weight}, dp=dp)

    def device_batch(seed):
        b = make_batch(seed)
        return to_device(b if dp is None else shard(b, dp), device)

    if on_start is not None:
        on_start(model, device_batch)

    out_dir = Path(args.output)
    records, step_s = [], []
    if main_rank:
        out_dir.mkdir(parents=True, exist_ok=True)
    mf = open(out_dir / "metrics.jsonl", "a" if args.resume else "w") if main_rank else None
    t0 = time.perf_counter()
    try:
        for s in range(start_step, args.steps):
            batch = device_batch(args.seed + s + 1)
            ts = time.perf_counter()
            metrics = step(batch)
            rec = {"step": s, **{k: round(float(metrics[k]), 5) for k in sorted(metrics)}}
            step_s.append(time.perf_counter() - ts)  # float() waited for the step
            if args.warmup:
                rec["lr"] = round(float(lr(s)), 8)
            records.append(rec)
            if not main_rank:
                continue
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
            if s == 0 or (s + 1) % 10 == 0:
                extra = ""
                if "regr3d" in rec:
                    extra = f"regr={rec['regr3d']:.4f} match={rec['matching']:.4f} "
                print(f"step {s}: loss={rec['loss']:.4f} {extra}"
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if args.ckpt_every and (s + 1) % args.ckpt_every == 0:
                save_params(out_dir / f"params_{s + 1:06d}.npz", model, args.objective)
                save_state(out_dir / "state_last.npz", model, optimizer, s + 1)
    finally:
        if mf is not None:
            mf.close()
    if main_rank:
        save_params(out_dir / "params_final.npz", model, args.objective)
        if args.objective == "croco" and args.export_dust3r:
            save_trunk(out_dir / "dust3r_trunk.npz", model)
            print(f"dust3r-layout trunk -> {out_dir / 'dust3r_trunk.npz'}")
        print(f"pretraining finished -> {out_dir}")
    if dp is not None:
        dp.close()
    return {"model": model, "optimizer": optimizer, "step": step, "device_batch": device_batch,
            "records": records, "step_s": step_s, "out_dir": out_dir, "args": args}


if __name__ == "__main__":
    main()
