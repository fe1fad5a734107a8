"""CroCo-Stereo / CroCo-Flow: train, evaluate and predict (counterpart of
gd3d/cli/stereoflow.py; dust3r/croco/stereoflow/train.py and test.py).

Usage:
  python -m gd3d_torch.cli.stereoflow train --task stereo|flow --root DIR \\
      --output DIR [--layout generic|sceneflow|kitti15|sintel|eth3d|middlebury] \\
      [--criterion STR] [--crop H W] [--steps 100] [--batch 2] [--lr LR] \\
      [--warmup 10] [--weight-decay 0.05] [--seed 0] [--ckpt-every N]
  python -m gd3d_torch.cli.stereoflow eval --task ... --root DIR --output DIR \\
      [--layout ...] [--split train|test] [--tile-overlap 0.7] \\
      [--tile-conf-mode MODE] [--crop H W] [--save metrics pred visu]
  python -m gd3d_torch.cli.stereoflow predict --task ... --left IMG --right IMG \\
      --output FILE.npy|.pfm|.flo|.png [--visu FILE.png] [--tile-overlap 0.7]
  every subcommand: [--tiny] [--ckpt params.npz | --torch-ckpt crocostereo.pth]
      [--no-conf] [--device cuda] [--tile-batch N]

gd3d's flags, files and defaults: train writes train_log.jsonl and
params_final.npz (gd3d's flattened param tree, 'a/b/c' keys, which gd3d's
--ckpt loads, and which --ckpt here reads from either package); eval writes
metrics.json and, with --save, <name>_pred.npy and <name>_pred.png; predict
writes the prediction in the format of its extension. Without a checkpoint
the model takes the port's seeded init (torch.Generator seed 0) with a
warning; --torch-ckpt reads the upstream CroCoDownstreamBinocular .pth and
its pickled args. It runs on the card unless --device says otherwise;
asking for cuda without one raises. --tile-batch caps the tiles a forward
of tiled_pred takes (all of a pair's tiles by default, as gd3d). The module
imports torch inside its functions only.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("python -m gd3d_torch.cli.stereoflow")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--task", choices=["stereo", "flow"], default="stereo")
        sp.add_argument("--tiny", action="store_true", help="2-layer test model (CPU sized)")
        sp.add_argument("--ckpt", type=str, default=None,
                        help="params .npz (gd3d's flattened param tree) to load")
        sp.add_argument("--torch-ckpt", type=str, default=None,
                        help="reference CroCoDownstreamBinocular .pth to load "
                             "(crocostereo.pth layout)")
        sp.add_argument("--no-conf", action="store_true",
                        help="criterion without confidence channel")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
        sp.add_argument("--tile-batch", type=int, default=None,
                        help="tiles a forward of the tiled prediction takes (default: all)")

    t = sub.add_parser("train", help="fine-tune on (left, right, gt) pairs")
    common(t)
    t.add_argument("--root", required=True)
    t.add_argument("--layout", default="generic",
                   help="generic|sceneflow|kitti15|sintel|eth3d|middlebury")
    t.add_argument("--output", required=True)
    t.add_argument("--criterion", default=None,
                   help="reference criterion string; default per task (train.py:52)")
    t.add_argument("--crop", type=int, nargs=2, default=None,
                   help="training crop; default 352 704 stereo / 320 384 flow")
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch", type=int, default=2)
    t.add_argument("--lr", type=float, default=None, help="default 3e-5 stereo / 2e-5 flow")
    t.add_argument("--warmup", type=int, default=10)
    t.add_argument("--weight-decay", type=float, default=0.05)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--ckpt-every", type=int, default=0)

    e = sub.add_parser("eval", help="tiled evaluation with dataset metrics")
    common(e)
    e.add_argument("--root", required=True)
    e.add_argument("--layout", default="generic")
    e.add_argument("--split", default="train", choices=["train", "test"],
                   help="dataset split for layouts that have one (kitti15 training/ vs "
                        "testing/, sintel)")
    e.add_argument("--output", required=True)
    e.add_argument("--tile-overlap", type=float, default=0.7)
    e.add_argument("--tile-conf-mode", default=None,
                   help="default conf_expsigmoid_15_3 stereo / _10_5 flow")
    e.add_argument("--crop", type=int, nargs=2, default=None)
    e.add_argument("--save", nargs="*", default=["metrics"], help="metrics | pred | visu")

    pr = sub.add_parser("predict", help="one pair -> prediction file")
    common(pr)
    pr.add_argument("--left", required=True)
    pr.add_argument("--right", required=True)
    pr.add_argument("--output", required=True,
                    help=".npy/.pfm/.flo/.png target (format from extension)")
    pr.add_argument("--visu", type=str, default=None,
                    help="also write a visualization png here")
    pr.add_argument("--tile-overlap", type=float, default=0.7)
    pr.add_argument("--tile-conf-mode", default=None)
    pr.add_argument("--crop", type=int, nargs=2, default=None)
    return p.parse_args(argv)


def model_config(args):
    """gd3d's config for the flags: the full CroCo v2 ViT-L/Base model, or
    --tiny's (gd3d/cli/stereoflow.py:98-107)."""
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.stereoflow import StereoFlowConfig

    if args.tiny:
        croco = CrocoConfig(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                            dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
        return StereoFlowConfig(croco=croco, task=args.task, with_conf=not args.no_conf,
                                hooks=(0, 1, 2, 3), dpt_layer_dims=(8, 16, 24, 32),
                                dpt_feature_dim=16, dpt_last_dim=8)
    return StereoFlowConfig(task=args.task, with_conf=not args.no_conf)


def build_model(args, device):
    """The model on `device` with the flags' weights."""
    import torch

    from gd3d_torch.convert import stereoflow_state_dict, unflatten
    from gd3d_torch.models.stereoflow import StereoFlow, convert_stereoflow
    from gd3d_torch.models.vit import init_params_

    cfg = model_config(args)
    with device:
        model = StereoFlow(cfg)
    if args.torch_ckpt:
        # weights_only=False: the released checkpoints pickle an
        # argparse.Namespace under 'args' (stereoflow/test.py:56)
        ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
        model.load_state_dict(convert_stereoflow(ckpt.get("model", ckpt), cfg))
    elif args.ckpt:
        with np.load(args.ckpt) as z:
            flat = {k: z[k] for k in z.files}
        model.load_state_dict(stereoflow_state_dict(unflatten(flat), cfg))
    else:
        print("WARNING: no --ckpt or --torch-ckpt; random CroCo-Stereo/Flow weights")
        init_params_(model, torch.Generator(device=device).manual_seed(0))
    return model, cfg


def save_params(path, model) -> None:
    """The model's weights as gd3d's flattened param tree."""
    from gd3d_torch.convert import stereoflow_params

    np.savez(path, **stereoflow_params(model.state_dict()))


def criterion_for(args):
    from gd3d_torch.stereoflow import CRITERIA, DEFAULT_CRITERION

    explicit = getattr(args, "criterion", None)
    name = explicit or DEFAULT_CRITERION[args.task]
    if name not in CRITERIA:
        raise SystemExit(f"unknown criterion {name!r}; choices: {sorted(CRITERIA)}")
    if args.no_conf:
        if explicit and CRITERIA[explicit].with_conf:
            raise SystemExit(f"--no-conf is incompatible with {explicit!r} (it consumes a "
                             "confidence channel); drop one of the two flags")
        name = "L1Loss()"
    return CRITERIA[name]


def crop_for(args):
    from gd3d_torch.stereoflow import DEFAULT_CROP

    if args.crop:
        return tuple(args.crop)
    return (64, 96) if args.tiny else DEFAULT_CROP[args.task]


def cmd_train(args, device) -> dict:
    """Returns the output dir, the model, the optimizer, the step records
    and stats (step_s a step, peak GiB on the card)."""
    import torch

    from gd3d_torch.data.flowio import StereoFlowPairs, discover_pairs
    from gd3d_torch.stereoflow import build_stereoflow_train_step, make_stereoflow_optimizer

    crit = criterion_for(args)
    pairs = [p for p in discover_pairs(args.root, args.layout, args.task) if p[2] is not None]
    if not pairs:
        raise SystemExit(f"no training pairs with gt under {args.root}")
    model, cfg = build_model(args, device)
    model.train()
    ds = StereoFlowPairs(pairs, args.task, crop_size=crop_for(args), seed=args.seed)
    lr = args.lr or {"stereo": 3e-5, "flow": 2e-5}[args.task]
    opt = make_stereoflow_optimizer(model, lr, args.steps, args.warmup, args.weight_decay)
    step = build_stereoflow_train_step(model, crit, opt)

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    records, step_s = [], []
    t0 = time.perf_counter()
    with open(out / "train_log.jsonl", "a") as log:
        for s in range(args.steps):
            items = [ds[int(rng.randint(len(ds)))] for _ in range(args.batch)]
            batch = [torch.from_numpy(np.stack([it[k] for it in items])).to(device)
                     for k in ("img1", "img2", "gt")]
            ts = time.perf_counter()
            loss = float(step(*batch))  # waits for the step
            step_s.append(time.perf_counter() - ts)
            rec = {"step": s, "loss": loss, "wall_s": round(time.perf_counter() - t0, 2)}
            records.append(rec)
            log.write(json.dumps(rec) + "\n")
            log.flush()
            if s % max(1, args.steps // 10) == 0:
                print(f"step {s}: loss {rec['loss']:.4f}", flush=True)
            if args.ckpt_every and (s + 1) % args.ckpt_every == 0:
                save_params(out / f"params_{s + 1:06d}.npz", model)
    save_params(out / "params_final.npz", model)
    print(f"training finished -> {out / 'params_final.npz'}")
    return {"out_dir": out, "model": model, "optimizer": opt, "records": records,
            "stats": {"step_s": step_s}}


def tiled_predictor(model, args, device):
    """predict(img1, img2) on ImageNet-normalized (H, W, 3) arrays ->
    (pred (H, W, C), conf (H, W)) host arrays, through tiled_pred."""
    import torch

    from gd3d_torch.stereoflow import DEFAULT_TILE_CONF_MODE, tiled_pred
    from gd3d_torch.teachers.mast3r import no_tf32

    crop = crop_for(args)
    conf_mode = args.tile_conf_mode or DEFAULT_TILE_CONF_MODE[args.task]

    @torch.no_grad()
    def predict(img1_np, img2_np):
        with no_tf32():
            pred, _, c = tiled_pred(model, torch.from_numpy(img1_np[None]).to(device),
                                    torch.from_numpy(img2_np[None]).to(device), crop=crop,
                                    overlap=args.tile_overlap, conf_mode=conf_mode,
                                    tile_batch=args.tile_batch)
        return pred[0].cpu().numpy(), c[0].cpu().numpy()

    return predict


def cmd_eval(args, device) -> dict:
    from gd3d_torch.data.flowio import StereoFlowPairs, discover_pairs
    from gd3d_torch.stereoflow import FlowDatasetMetrics, StereoDatasetMetrics

    model, cfg = build_model(args, device)
    model.eval()
    predict = tiled_predictor(model, args, device)
    ds = StereoFlowPairs(discover_pairs(args.root, args.layout, args.task, split=args.split),
                         args.task, root=args.root)
    agg = (StereoDatasetMetrics if args.task == "stereo" else FlowDatasetMetrics)()
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    res = None
    for i in range(len(ds)):
        item = ds[i]
        pred, _ = predict(item["img1"], item["img2"])
        if "gt" in item:
            agg.add_batch(pred[None], item["gt"][None])
        if "pred" in args.save:
            np.save(out / f"{item['name']}_pred.npy", pred)
        if "visu" in args.save:
            write_visu(out / f"{item['name']}_pred.png", pred, args.task, item.get("gt"))
        print(f"[{i + 1}/{len(ds)}] {item['name']}", flush=True)
    if "metrics" in args.save:
        res = agg.get_results()
        with open(out / "metrics.json", "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res))
    return {"out_dir": out, "metrics": res, "pairs": len(ds)}


def write_visu(path, pred, task, gt=None) -> None:
    """The prediction's picture as gd3d writes it with cv2.imwrite: the
    INFERNO disparity (BGR) or the flow colours (RGB), an 8-bit RGB PNG."""
    from gd3d_torch.data.flowio import flow_to_color, vis_disparity
    from gd3d_torch.data.png import encode_png

    if task == "stereo":
        m = M = None
        if gt is not None and np.isfinite(gt).any():
            m = float(gt[np.isfinite(gt)].min())
            M = float(gt[np.isfinite(gt)].max())
        rgb = vis_disparity(pred[..., 0], m=m, M=M)[..., ::-1]
    else:
        ref = gt if gt is not None else pred
        fin = ref[np.isfinite(ref[..., 0])]
        norm = float(np.sqrt((fin ** 2).sum(-1)).max()) if fin.size else None
        rgb = flow_to_color(pred.astype(np.float32), maxflow=norm)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(rgb)))


def cmd_predict(args, device) -> dict:
    from gd3d_torch.data.flowio import (img_to_array, read_img, write_flo, write_kitti_disp,
                                        write_kitti_flow, write_pfm)

    outp = args.output
    ext = os.path.splitext(outp)[1].lower()
    if ext not in (".npy", ".pfm", ".flo", ".png"):
        raise SystemExit(f"unknown output format {ext!r}")
    model, cfg = build_model(args, device)
    model.eval()
    predict = tiled_predictor(model, args, device)
    img1 = img_to_array(read_img(args.left).astype(np.float32))
    img2 = img_to_array(read_img(args.right).astype(np.float32))
    pred, _ = predict(img1, img2)
    Path(outp).parent.mkdir(parents=True, exist_ok=True)
    if ext == ".npy":
        np.save(outp, pred)
    elif ext == ".pfm" and args.task == "stereo":
        write_pfm(outp, pred[..., 0].astype(np.float32))
    elif ext == ".pfm":
        # flow PFMs are 3-channel with a zero third band (read_pfm_flow)
        zero = np.zeros_like(pred[..., :1])
        write_pfm(outp, np.concatenate([pred, zero], -1).astype(np.float32))
    elif ext == ".flo":
        write_flo(outp, pred)
    elif args.task == "stereo":
        write_kitti_disp(outp, pred[..., 0])
    else:
        write_kitti_flow(outp, pred)
    if args.visu:
        write_visu(args.visu, pred, args.task)
    print(f"prediction -> {outp}")
    return {"out": outp, "pred": pred}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from gd3d_torch.cli.align import resolve_device

    if args.cmd == "train":
        criterion_for(args)  # a bad flag combination exits before anything is read
    device = resolve_device(args.device)
    return {"train": cmd_train, "eval": cmd_eval, "predict": cmd_predict}[args.cmd](args, device)


if __name__ == "__main__":
    main()
