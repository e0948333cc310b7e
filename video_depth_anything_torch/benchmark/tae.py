"""Temporal Alignment Error (the port's copy of the JAX package's
``benchmark/tae.py``).

Per consecutive frame pair: back-project the aligned depth of frame 1
with K, move it by the relative pose, project it into frame 2 with
last-write-wins rasterisation (plain indexed assignment, not a z-buffer
minimum), masked AbsRel against depth 2, both directions, x100.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .evaluate import load_gt_depth, load_infer


def tae_pair(depth1: np.ndarray, depth2: np.ndarray, r_2_1: np.ndarray,
             t_2_1: np.ndarray, k: np.ndarray, mask: np.ndarray) -> float:
    """tae_torch (eval_tae.py:60-107) in NumPy."""
    h, w = depth1.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    yy, xx = np.mgrid[0:h, 0:w].astype(depth1.dtype)
    x3 = (xx - cx) * depth1 / fx
    y3 = (yy - cy) * depth1 / fy
    pts = np.stack([x3.ravel(), y3.ravel(), depth1.ravel()], axis=1)
    pts = pts @ r_2_1.T + t_2_1
    xw, yw, zw = pts[:, 0], pts[:, 1], pts[:, 2]
    xp = np.round(xw * fx / zw + cx).astype(np.int64)
    yp = np.round(yw * fy / zw + cy).astype(np.int64)
    ok = (xp >= 0) & (xp < w) & (yp >= 0) & (yp < h)
    if ok.sum() == 0:
        return 0.0
    proj = np.zeros((h, w), depth1.dtype)
    proj[yp[ok], xp[ok]] = zw[ok]  # last-write-wins, as in the reference
    valid = (proj > 0) & (depth2 > 0) & mask
    if valid.sum() == 0:
        return 0.0
    gt, pred = depth2[valid], proj[valid]
    return float(np.mean(np.abs(gt - pred) / gt))


def eval_tae_sequence(pred_disps: np.ndarray, gt_depths: np.ndarray,
                      ks: List[np.ndarray], poses: List[np.ndarray],
                      max_depth: float,
                      masks: Optional[List[np.ndarray]] = None) -> float:
    """eval_TAE (eval_tae.py:109-217): video-lstsq align, then symmetric
    pairwise reprojection error x100."""
    valid_mask = np.logical_and(gt_depths > 1e-3, gt_depths < max_depth)
    pred_disps = np.clip(pred_disps, a_min=1e-3, a_max=None)
    gt_disp = 1.0 / (gt_depths[valid_mask].reshape(-1, 1).astype(np.float64) + 1e-8)
    pred = pred_disps[valid_mask].reshape(-1, 1).astype(np.float64)
    a = np.concatenate([pred, np.ones_like(pred)], axis=-1)
    scale, shift = np.linalg.lstsq(a, gt_disp, rcond=None)[0]
    aligned = np.clip(scale * pred_disps + shift, a_min=1e-3, a_max=None)
    pred_depth = np.zeros_like(aligned)
    pos = aligned > 0
    pred_depth[pos] = 1.0 / aligned[pos]
    pred_depth = np.clip(pred_depth, a_min=1e-3, a_max=max_depth)

    n = pred_depth.shape[0]
    err = 0.0
    for i in range(n - 1):
        t_2_1 = np.linalg.inv(poses[i + 1]) @ poses[i]
        m2 = masks[i + 1] if masks else np.ones_like(pred_depth[i + 1], bool)
        m1 = masks[i] if masks else np.ones_like(pred_depth[i], bool)
        err += tae_pair(pred_depth[i], pred_depth[i + 1],
                        t_2_1[:3, :3], t_2_1[:3, 3], ks[i], m2)
        t_1_2 = np.linalg.inv(t_2_1)
        err += tae_pair(pred_depth[i + 1], pred_depth[i],
                        t_1_2[:3, :3], t_1_2[:3, 3], ks[i], m1)
    return err / (2 * (n - 1)) * 100.0


def main(argv=None):
    """Driver matching eval_tae.py:220-293 (scannet protocol)."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--infer_path", type=str, default="")
    parser.add_argument("--benchmark_path", type=str, default="")
    parser.add_argument("--datasets", type=str, nargs="+", default=["scannet"])
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=180)
    parser.add_argument("--eval_scenes_num", type=int, default=20)
    args = parser.parse_args(argv)

    for dataset in args.datasets:
        # Prefer the TAE manifest (K + pose per frame, written by the
        # extractor as <dataset>_video_tae.json). The reference driver reads
        # <dataset>_video.json (eval_tae.py:264) even though its own
        # extractor writes the K/pose entries only to the _tae file
        # (dataset_extract_scannet.py:111-112) — a latent manifest mismatch
        # fixed here, like metric run.py's --save_exr (PARITY.md A2).
        json_file = os.path.join(args.benchmark_path,
                                 f"{dataset}/{dataset}_video_tae.json")
        if not os.path.exists(json_file):
            json_file = os.path.join(args.benchmark_path,
                                     f"{dataset}/{dataset}_video.json")
        root = os.path.join(args.benchmark_path, dataset)
        crop = (8, -8, 11, -11)
        max_depth = 10.0
        with open(json_file) as f:
            manifest = json.load(f)
        total, count = 0.0, 0
        for scene in manifest[dataset][: args.eval_scenes_num]:
            for _, frames in scene.items():
                frames = frames[args.start_idx: args.end_idx]
                gts, preds, ks, poses = [], [], [], []
                for img in frames:
                    p = os.path.join(args.infer_path, dataset, img["image"])
                    p = p.replace(".jpg", ".npy").replace(".png", ".npy")
                    if not os.path.exists(p):
                        continue
                    gt = load_gt_depth(os.path.join(root, img["gt_depth"]),
                                       img["factor"])
                    gt = gt[crop[0]:crop[1], crop[2]:crop[3]]
                    gts.append(gt)
                    preds.append(load_infer(p, target_size=gt.shape))
                    ks.append(np.asarray(img["K"]))
                    poses.append(np.asarray(img["pose"]))
                if len(gts) >= 2:
                    total += eval_tae_sequence(np.stack(preds), np.stack(gts),
                                               ks, poses, max_depth)
                    count += 1
        print(dataset, ": tae", total / max(count, 1))
        with open(os.path.join(args.infer_path, "results.txt"), "a") as f:
            f.write(f"{dataset}: {total / max(count, 1)}\n")


if __name__ == "__main__":
    main()
