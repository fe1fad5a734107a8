"""In-training evaluation callback (counterpart of gd3d/eval/callback.py).

Each configured method runs when its dataset exists under `data_root`,
writes its CSVs under <out_dir>/epoch_<N>/, and adds its column means to the
returned summary (keys eval/pck_{same,diff}/<col>, eval/tracking/<col> and
eval/pose/<col>). "pose" is OnePose-LowTexture (gd3d_torch/eval/onepose.py),
its RANSAC gd3d_torch/eval/pnp.py, which repeats cv2.solvePnPRansac
operation for operation and is held to cv2 by tests/test_torch_pnp.py.
"""
from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

if TYPE_CHECKING:  # the module imports no torch: the train CLI imports it at its top
    from gd3d_torch.models.student import Student


def pose_data_exists(data_root: str) -> bool:
    root = Path(data_root)
    return ((root / "lowtexture_test_data").exists()
            and (root / "sfm_output" / "outputs_softmax_loftr_loftr").exists())


def run_eval_callback(student: Student, methods: Sequence[str], data_root: str,
                      out_dir: str, epoch: int, refine: bool = True, num_videos: int = 30,
                      pck_categories: Optional[Sequence[str]] = None, img_size: int = 640,
                      tracking_size: Tuple[int, int] = (476, 854),
                      num_pose_objs: Optional[int] = None,
                      pool: Optional[concurrent.futures.Executor] = None) -> Dict[str, float]:
    """Run every configured eval whose data exist. Returns scalar means keyed
    'eval/<method>/<metric>'. img_size and tracking_size are gd3d's harness
    sizes (640 canvas, 476 x 854 frames); images are decoded in `pool` when
    one is given."""
    root = Path(data_root)
    edir = Path(out_dir) / f"epoch_{epoch}"
    summary: Dict[str, float] = {}

    if "semantic_transfer" in methods and (root / "PF-dataset-PASCAL").exists():
        from gd3d_torch.eval.pck import semantic_transfer

        edir.mkdir(parents=True, exist_ok=True)
        # both view modes, as gd3d's callback
        for same_view, tag in ((True, "same"), (False, "diff")):
            table = semantic_transfer(student, str(root / "PF-dataset-PASCAL"),
                                      categories=pck_categories, same_view=same_view,
                                      img_size=img_size, refine=refine, pool=pool)
            table.to_csv(edir / f"semantic_transfer_{tag}.csv")
            for col, v in table.mean().items():
                summary[f"eval/pck_{tag}/{col}"] = float(v)

    pkl, videos = root / "tapvid_davis_data_strided.pkl", root / "davis_480"
    if "tracking" in methods and pkl.exists() and videos.exists():
        from gd3d_torch.eval.tracking import tracking

        edir.mkdir(parents=True, exist_ok=True)
        table = tracking(student, num_videos=num_videos, benchmark_pkl=str(pkl),
                         video_root=str(videos), refine=refine, size_hw=tracking_size,
                         pool=pool)
        table.to_csv(edir / "tracking.csv")
        for col, v in table.mean().items():
            summary[f"eval/tracking/{col}"] = float(v)

    if "pose" in methods and pose_data_exists(data_root):
        from gd3d_torch.eval.onepose import oneposepp

        edir.mkdir(parents=True, exist_ok=True)
        table = oneposepp(student, root=str(root / "lowtexture_test_data"),
                          sfm_dir=str(root / "sfm_output" / "outputs_softmax_loftr_loftr"),
                          num_objs=num_pose_objs, refine=refine, pool=pool)
        table.to_csv(edir / "pose_estimation.csv")
        for col, v in table.mean().items():
            summary[f"eval/pose/{col}"] = float(v)

    return summary
