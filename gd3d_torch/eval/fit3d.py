"""FiT3D baseline comparison harness (counterpart of gd3d/eval/fit3d.py,
parity target src/evaluate_timm_fit3d.py).

A FiT3D-finetuned CLIP ViT-B/16 (upstream: HF `yuanwenyue/FiT3D`) and the
vanilla backbone, both the vanilla student architecture (no LoRA, no
adapters, no refine conv: every evaluation runs with refine=False), go
through the same evaluations: PF-PASCAL PCK, TAP-Vid DAVIS tracking and
OnePose-LowTexture pose. The checkpoint is a local .pth or an http(s) URL,
fetched with torch.hub.load_state_dict_from_url as gd3d does (cached under
$TORCH_HOME/hub/checkpoints), and loaded into the port's timm key layout.
The tables are the port's Tables (gd3d_torch/eval/table.py), keyed
'{eval}/{model}'.

Usage: python -m gd3d_torch.eval.fit3d [--fit3d-ckpt fit3d.pth]
[--vanilla-ckpt timm.pth] [--data-root data] [--transfer] [--tracking]
[--pose] [--device cuda]
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

from gd3d_torch.core.config import StudentConfig

if TYPE_CHECKING:
    import concurrent.futures

    import torch

    from gd3d_torch.eval.table import Table
    from gd3d_torch.models.student import Student

VANILLA_CFG = StudentConfig(lora_start_block=12, use_adapters=False)

# the reference's default --ckpt (evaluate_timm_fit3d.py:634)
FIT3D_CKPT_URL = (
    "https://huggingface.co/yuanwenyue/FiT3D/resolve/main/"
    "clip_base_finetuned.pth")


def load_fit3d_state(ckpt: str) -> Dict[str, torch.Tensor]:
    """A FiT3D torch state dict from a local path or an http(s) URL, unwrapped
    from 'model' and 'state_dict' where it nests them. URLs go through
    torch.hub.load_state_dict_from_url (map_location="cpu"), the reference's
    download path (evaluate_timm_fit3d.py:673)."""
    import torch

    from gd3d_torch.cli.train import load_torch_state

    if not ckpt.startswith(("http://", "https://")):
        return load_torch_state(ckpt)
    state = torch.hub.load_state_dict_from_url(ckpt, map_location="cpu")
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if torch.is_tensor(v)}


def load_fit3d_student(ckpt_path: Optional[str], seed: int = 42, cfg: StudentConfig = VANILLA_CFG,
                       device="cuda") -> Student:
    """The vanilla-architecture student on `device`: seeded weights
    (torch.Generator(seed)), then the FiT3D (or any timm) checkpoint's ViT
    weights where one is given; eval mode, no gradients."""
    import torch

    from gd3d_torch.cli.train import load_upstream
    from gd3d_torch.models.student import Student
    from gd3d_torch.models.vit import init_params_

    device = torch.device(device)
    with device:
        student = Student(cfg)
    init_params_(student, torch.Generator(device=device).manual_seed(seed))
    if ckpt_path:
        load_upstream(student.vit, load_fit3d_state(ckpt_path), may_miss=(".lora_", ".adapter."))
    student.requires_grad_(False)
    return student.eval()


def compare(fit3d_ckpt: str, vanilla_ckpt: Optional[str], data_root: str = "data",
            run_transfer: bool = True, run_tracking: bool = False, run_pose: bool = False,
            num_videos: int = 30, cfg: StudentConfig = VANILLA_CFG,
            transfer_kwargs: Optional[Dict] = None, device="cuda",
            pool: Optional[concurrent.futures.Executor] = None) -> Dict[str, Table]:
    """Side-by-side metric tables keyed '{eval}/{model}' (evaluate_timm_fit3d.py:
    628-691): each selected evaluation for the FiT3D model and the vanilla
    backbone, refine=False. cfg and transfer_kwargs let tests run the whole
    harness at tiny sizes; images are decoded in `pool` when one is given."""
    results: Dict[str, Table] = {}
    if vanilla_ckpt is None:
        # the reference baseline is the PRETRAINED backbone; random weights
        # would masquerade as it
        print("WARNING: no --vanilla-ckpt; the 'vanilla' column uses "
              "RANDOM weights and is not the reference baseline")
    models = {"fit3d": load_fit3d_student(fit3d_ckpt, cfg=cfg, device=device),
              "vanilla": load_fit3d_student(vanilla_ckpt, cfg=cfg, device=device)}
    for name, student in models.items():
        if run_transfer:
            from gd3d_torch.eval.pck import semantic_transfer

            results[f"transfer/{name}"] = semantic_transfer(
                student, f"{data_root}/PF-dataset-PASCAL", refine=False, pool=pool,
                **(transfer_kwargs or {}))
        if run_tracking:
            from gd3d_torch.eval.tracking import tracking

            results[f"tracking/{name}"] = tracking(
                student, num_videos=num_videos,
                benchmark_pkl=f"{data_root}/tapvid_davis_data_strided.pkl",
                video_root=f"{data_root}/davis_480", refine=False, pool=pool)
        if run_pose:
            from gd3d_torch.eval.onepose import oneposepp

            results[f"pose/{name}"] = oneposepp(
                student, root=f"{data_root}/lowtexture_test_data",
                sfm_dir=f"{data_root}/sfm_output/outputs_softmax_loftr_loftr",
                refine=False, pool=pool)
    return results


def main(argv=None) -> Dict[str, Table]:
    """CLI: gd3d's flags, plus --device (the card unless it says cpu) and
    --tiny (a 4-block, 32-wide vanilla student, 64^2 PCK canvas). Prints each
    table's means and returns the tables."""
    import argparse

    from gd3d_torch.eval.images import eval_workers, make_pool

    p = argparse.ArgumentParser(prog="python -m gd3d_torch.eval.fit3d")
    p.add_argument("--fit3d-ckpt", default=FIT3D_CKPT_URL,
                   help="local .pth or http(s) URL (default: the upstream HF ckpt, "
                        "matching the reference's --ckpt default)")
    p.add_argument("--vanilla-ckpt", default=None)
    p.add_argument("--data-root", default="data")
    p.add_argument("--transfer", action="store_true")
    p.add_argument("--tracking", action="store_true")
    p.add_argument("--pose", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--tiny", action="store_true", help="tiny student and PCK canvas")
    args = p.parse_args(argv)
    cfg, transfer_kwargs = VANILLA_CFG, None
    if args.tiny:
        cfg = dataclasses.replace(cfg, embed_dim=32, depth=4, num_heads=2, pretrain_img_size=32,
                                  depth_head_hidden=16)
        transfer_kwargs = {"img_size": 64}
    with make_pool(eval_workers(args.tiny)) as pool:
        results = compare(args.fit3d_ckpt, args.vanilla_ckpt, args.data_root,
                          run_transfer=args.transfer, run_tracking=args.tracking,
                          run_pose=args.pose, cfg=cfg, transfer_kwargs=transfer_kwargs,
                          device=args.device, pool=pool)
    for name, table in results.items():
        print(f"===== {name}")
        print(table.mean())
    return results


if __name__ == "__main__":
    main()
