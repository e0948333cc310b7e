"""Validation picture dumps (the port's copy of the JAX package's
``training/visualize.py``): per epoch, PNG grids of RGB / GT disparity /
mask / prediction, for watching training progress. cv2 is imported
inside the function."""
from __future__ import annotations

import os

import numpy as np

from ..config import IMAGENET_MEAN, IMAGENET_STD
from ..utils.video_io import depth_visualization


def _colorize(d: np.ndarray) -> np.ndarray:
    return depth_visualization(d[None])[0]


def dump_val_frames(out_dir: str, epoch: int, video: np.ndarray,
                    gt: np.ndarray, mask: np.ndarray, pred: np.ndarray,
                    max_frames: int = 4) -> list[str]:
    """video [T,H,W,3] normalized; gt/mask/pred [T,H,W]. Writes one PNG per
    frame with 4 panels side by side; returns the paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    paths = []
    for t in range(min(max_frames, video.shape[0])):
        rgb = np.clip((video[t] * std + mean) * 255, 0, 255).astype(np.uint8)
        panels = [rgb, _colorize(gt[t]),
                  np.repeat((mask[t][..., None] > 0).astype(np.uint8) * 255, 3, -1),
                  _colorize(pred[t])]
        grid = np.concatenate(panels, axis=1)
        path = os.path.join(out_dir, f"epoch{epoch:04d}_frame{t:02d}.png")
        cv2.imwrite(path, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
        paths.append(path)
    return paths
