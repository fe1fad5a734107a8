"""TAP-Vid metrics (numpy; the port's own copy of gd3d/eval/tracking_metrics.py).

Parity target: utils/tracking_metrics.py:7-224 — occlusion accuracy,
pts-within-{1,2,4,8,16}px, per-threshold Jaccard, averages, all at the
256x256-normalized scale; strided query mode for DAVIS.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np


def compute_tapvid_metrics(
    query_points: np.ndarray,
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    query_mode: str,
    get_trackwise_metrics: bool = False,
) -> Mapping[str, np.ndarray]:
    """See utils/tracking_metrics.py:7-147 (TAP-Vid paper metrics)."""
    summing_axis = (2,) if get_trackwise_metrics else (1, 2)
    metrics = {}

    eye = np.eye(gt_tracks.shape[2], dtype=np.int32)
    if query_mode == "first":
        query_frame_to_eval_frames = np.cumsum(eye, axis=1) - eye
    elif query_mode == "strided":
        query_frame_to_eval_frames = 1 - eye
    else:
        raise ValueError("Unknown query mode " + query_mode)

    query_frame = np.round(query_points[..., 0]).astype(np.int32)
    evaluation_points = query_frame_to_eval_frames[query_frame] > 0

    gt_occluded = gt_occluded.astype(bool)
    pred_occluded = pred_occluded.astype(bool)

    occ_acc = np.sum(
        np.equal(pred_occluded, gt_occluded) & evaluation_points,
        axis=summing_axis,
    ) / np.sum(evaluation_points, axis=summing_axis)
    metrics["occlusion_accuracy"] = occ_acc

    visible = ~gt_occluded
    pred_visible = ~pred_occluded
    all_frac_within = []
    all_jaccard = []
    for thresh in [1, 2, 4, 8, 16]:
        within_dist = (
            np.sum(np.square(pred_tracks - gt_tracks), axis=-1) < thresh**2
        )
        is_correct = within_dist & visible
        count_correct = np.sum(is_correct & evaluation_points, axis=summing_axis)
        count_visible = np.sum(visible & evaluation_points, axis=summing_axis)
        frac_correct = count_correct / count_visible
        metrics[f"pts_within_{thresh}"] = frac_correct
        all_frac_within.append(frac_correct)

        true_positives = np.sum(
            is_correct & pred_visible & evaluation_points, axis=summing_axis
        )
        gt_positives = np.sum(visible & evaluation_points, axis=summing_axis)
        false_positives = (~visible) & pred_visible
        false_positives = false_positives | ((~within_dist) & pred_visible)
        false_positives = np.sum(
            false_positives & evaluation_points, axis=summing_axis
        )
        jaccard = true_positives / (gt_positives + false_positives)
        metrics[f"jaccard_{thresh}"] = jaccard
        all_jaccard.append(jaccard)

    metrics["average_jaccard"] = np.mean(np.stack(all_jaccard, axis=1), axis=1)
    metrics["average_pts_within_thresh"] = np.mean(
        np.stack(all_frac_within, axis=1), axis=1
    )
    return metrics


def compute_tapvid_metrics_for_video(
    trajectories_dict: Dict,
    occlusions_dict: Dict,
    benchmark_data: Dict,
    video_idx: int,
    pred_video_sizes: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """utils/tracking_metrics.py:150-224 — including its query-point rescale
    quirk at :203-204 (y overwritten before x reads it)."""
    for vc in benchmark_data["videos"]:
        if vc["video_idx"] == video_idx:
            video = vc
            break
    pred_h = video["h"] if pred_video_sizes is None else pred_video_sizes[1]
    pred_w = video["w"] if pred_video_sizes is None else pred_video_sizes[0]

    qs, gto, gtt, po, pt = [], [], [], [], []
    for frame_idx in video["query_points"]:
        q = np.array(video["query_points"][frame_idx])
        t = np.full((q.shape[0], 1), frame_idx)
        qs.append(np.concatenate([t, q], axis=1))
        gtt.append(video["target_points"][frame_idx])
        gto.append(video["occluded"][frame_idx])
        pt.append(trajectories_dict[frame_idx])
        po.append(occlusions_dict[frame_idx])

    q = np.concatenate(qs, 0).astype(np.float32)
    gt_tracks = np.concatenate(gtt, 0).astype(np.float32)
    gt_occluded = np.concatenate(gto, 0)
    pred_tracks = np.concatenate(pt, 0).astype(np.float32)
    pred_occluded = np.concatenate(po, 0)

    # reference quirk (tracking_metrics.py:203-204): q[...,1] is assigned
    # from q[...,2] first, then q[...,2] reads the NEW q[...,1].
    q[..., 1] = q[..., 2] * 256 / video["h"]
    q[..., 2] = q[..., 1] * 256 / video["w"]
    gt_tracks = gt_tracks * np.array([256 / video["w"], 256 / video["h"]])
    pred_tracks = pred_tracks * np.array([256 / pred_w, 256 / pred_h])

    metrics = compute_tapvid_metrics(
        q[None], gt_occluded[None], gt_tracks[None],
        pred_occluded[None], pred_tracks[None], query_mode="strided",
    )
    return {k: float(np.asarray(v).item()) for k, v in metrics.items()}

