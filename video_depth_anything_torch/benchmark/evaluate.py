"""Geometric depth evaluation (the port's copy of the JAX package's
``benchmark/evaluate.py``).

Per sequence: load the predicted disparity (.npy) and the GT depth, crop
the dataset's window, fit ONE video-level affine (scale, shift) from
predicted to GT disparity by float64 least squares over every valid
pixel, invert to depth, clamp, and average AbsRel / RMSE / delta1 over
sequences. cv2 is imported inside the functions that read images.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

from . import metrics

EVAL_METRIC_NAMES = ["abs_relative_difference", "rmse_linear", "delta1_acc"]


@dataclasses.dataclass
class DatasetEvalConfig:
    json_file: str
    root_path: str
    max_depth_eval: float
    min_depth_eval: float
    max_eval_len: int
    crop: tuple  # (a, b, c, d) -> gt[a:b, c:d]
    name: str


def dataset_eval_config(dataset: str, benchmark_path: str) -> DatasetEvalConfig:
    """eval.py:141-224 table (incl. _500 variants)."""
    table = {
        "kitti": ("kitti/kitti_video.json", "kitti", 80.0, 110, (0, 374, 0, 1242)),
        "kitti_500": ("kitti/kitti_video_500.json", "kitti", 80.0, 500, (0, 374, 0, 1242)),
        "sintel": ("sintel/sintel_video.json", "sintel", 70.0, 100, (0, 436, 0, 1024)),
        "nyuv2": ("nyuv2/nyuv2_video.json", "nyuv2", 10.0, 110, (45, 471, 41, 601)),
        "nyuv2_500": ("nyuv2/nyuv2_video_500.json", "nyuv2", 10.0, 500, (45, 471, 41, 601)),
        "bonn": ("bonn/bonn_video.json", "bonn", 10.0, 110, (0, 480, 0, 640)),
        "bonn_500": ("bonn/bonn_video_500.json", "bonn", 10.0, 500, (0, 480, 0, 640)),
        "scannet": ("scannet/scannet_video.json", "scannet", 10.0, 90, (8, -8, 11, -11)),
        "scannet_500": ("scannet/scannet_video_500.json", "scannet", 10.0, 500, (8, -8, 11, -11)),
        "vkitti": ("vkitti/vkitti_video.json", "vkitti", 80.0, 110, (0, 375, 0, 1242)),
    }
    jf, root, maxd, maxlen, crop = table[dataset]
    return DatasetEvalConfig(
        json_file=os.path.join(benchmark_path, jf),
        root_path=os.path.join(benchmark_path, root),
        max_depth_eval=maxd, min_depth_eval=0.1, max_eval_len=maxlen,
        crop=crop, name=dataset.split("_")[0])


def load_gt_depth(path: str, factor: float) -> np.ndarray:
    """eval.py:42-50: 16-bit png (or .npy) / factor; zeros -> -1 (invalid)."""
    if path.endswith(".npy"):
        gt = np.load(path)
    else:
        import cv2
        gt = np.asarray(cv2.imread(path, -1))
    gt = gt / factor
    gt = np.where(gt == 0, -1.0, gt)
    return gt


def load_infer(path: str, target_size=None) -> np.ndarray:
    """eval.py:24-40: predicted disparity .npy (or 8-bit grayscale image)."""
    if path.endswith(".npy"):
        infer = np.load(path).astype(np.float32)
    else:
        import cv2
        img = cv2.imread(path)
        infer = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32) * 255.0
    if target_size is not None and infer.shape[:2] != tuple(target_size):
        import cv2
        infer = cv2.resize(infer, (target_size[1], target_size[0]))
    return infer


def align_disparity_lstsq(pred_disp: np.ndarray, gt_depth: np.ndarray,
                          valid_mask: np.ndarray):
    """Video-level affine fit pred_disp -> gt_disp in float64
    (eval.py:87-98). Returns (scale, shift)."""
    gt_disp = 1.0 / (gt_depth[valid_mask].reshape(-1, 1).astype(np.float64) + 1e-8)
    pred = pred_disp[valid_mask].reshape(-1, 1).astype(np.float64)
    a = np.concatenate([pred, np.ones_like(pred)], axis=-1)
    x = np.linalg.lstsq(a, gt_disp, rcond=None)[0]
    return x[0].item(), x[1].item()


def eval_sequence(pred_disps: np.ndarray, gt_depths: np.ndarray,
                  max_depth: float) -> List[float]:
    """One sequence -> [abs_rel, rmse, delta1] (eval.py:67-122 math)."""
    valid_mask = np.logical_and(gt_depths > 1e-3, gt_depths < max_depth)
    pred_disps = np.clip(pred_disps, a_min=1e-3, a_max=None)
    scale, shift = align_disparity_lstsq(pred_disps, gt_depths, valid_mask)
    aligned = np.clip(scale * pred_disps + shift, a_min=1e-3, a_max=None)
    pred_depth = np.zeros_like(aligned)
    pos = aligned > 0
    pred_depth[pos] = 1.0 / aligned[pos]
    pred_depth = np.clip(pred_depth, a_min=1e-3, a_max=max_depth)

    frame_ok = valid_mask.sum((-1, -2)) > 0
    pd, gd, vm = pred_depth[frame_ok], gt_depths[frame_ok], valid_mask[frame_ok]
    return [float(metrics.EVAL_METRICS[name](pd, gd, vm))
            for name in EVAL_METRIC_NAMES]


def eval_dataset(infer_path: str, cfg: DatasetEvalConfig,
                 results_file=None) -> Dict[str, float]:
    """Loop over the JSON manifest (eval.py:226-264)."""
    with open(cfg.json_file) as f:
        manifest = json.load(f)
    a, b, c, d = cfg.crop
    results = []
    for seq in manifest[cfg.name]:
        for _, frames in seq.items():
            gts, preds = [], []
            for img in frames[: cfg.max_eval_len]:
                pred_path = os.path.join(infer_path, cfg.name, img["image"])
                pred_path = pred_path.replace(".jpg", ".npy").replace(".png", ".npy")
                if not os.path.exists(pred_path):
                    continue
                gt = load_gt_depth(os.path.join(cfg.root_path, img["gt_depth"]),
                                   img["factor"])[a:b, c:d]
                preds.append(load_infer(pred_path, target_size=gt.shape))
                gts.append(gt)
            if gts:
                results.append(eval_sequence(np.stack(preds), np.stack(gts),
                                             cfg.max_depth_eval))
    if not results:
        raise ValueError(
            f"no predictions under {infer_path!r} matched the "
            f"'{cfg.name}' manifest — run benchmark inference first")
    mean = np.mean(np.asarray(results), axis=0)
    out = {name: float(mean[i]) for i, name in enumerate(EVAL_METRIC_NAMES)}
    if results_file:
        with open(results_file, "a") as f:
            f.write(f"<{'-'*50} {cfg.name} start {'-'*50}>\n")
            for k, v in out.items():
                f.write(f"{k}: {v:04f}\n")
            f.write(f"<{'-'*50} {cfg.name} finish {'-'*50}>\n")
    return out


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--infer_path", type=str, default="")
    parser.add_argument("--benchmark_path", type=str, default="")
    parser.add_argument("--datasets", type=str, nargs="+",
                        default=["sintel", "scannet", "kitti", "bonn"])
    args = parser.parse_args(argv)
    results_path = os.path.join(args.infer_path, "results.txt")
    for ds in args.datasets:
        cfg = dataset_eval_config(ds, args.benchmark_path)
        out = eval_dataset(args.infer_path, cfg, results_file=results_path)
        print(ds, out)


if __name__ == "__main__":
    main()
