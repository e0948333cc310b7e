"""Google Landmarks single-image dataset and the combined dataset (the
port's copy of the JAX package's ``data/landmarks.py``; NumPy and PIL)."""
from __future__ import annotations

import os
import random
from glob import glob
from typing import Dict

import numpy as np

from .vkitti import (IMAGENET_MEAN, IMAGENET_STD, _crop, _pil,
                     random_crop_params, resize_shorter_side)


class GoogleLandmarksDataset:
    """Single-image clips: image dir glob + parallel .npy disparity dir,
    ImageNet normalize + shared random crop, validity mask [1/80, 1000]."""

    def __init__(self, image_root: str, depth_root: str, clip_len: int = 1,
                 resize_size: int = 518, min_disp: float = 1.0 / 80.0,
                 max_disp: float = 1000.0, seed: int = 0):
        self.image_paths = sorted(glob(os.path.join(image_root, "**", "*.*"),
                                       recursive=True))
        self.depth_paths = [
            p.replace(image_root, depth_root).rsplit(".", 1)[0] + ".npy"
            for p in self.image_paths]
        for dp in self.depth_paths:
            if not os.path.isfile(dp):
                raise FileNotFoundError(f"depth file not found: {dp}")
        self.resize_size = resize_size
        self.min_disp = min_disp
        self.max_disp = max_disp
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        Image = _pil()
        img = Image.open(self.image_paths[idx]).convert("RGB")
        img = resize_shorter_side(img, self.resize_size)
        ci, cj, th, tw = random_crop_params(img, self.resize_size, self.rng)
        rgb = np.asarray(_crop(img, ci, cj, th, tw), np.float32) / 255.0
        rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD

        disp = np.load(self.depth_paths[idx]).astype(np.float32)
        disp_img = _crop(Image.fromarray(disp), ci, cj, th, tw)
        disp = np.asarray(disp_img, np.float32)
        mask = ((disp >= self.min_disp) & (disp <= self.max_disp))
        return {
            "video": rgb[None],                     # [1,H,W,3]
            "gt": disp[None],                       # [1,H,W]
            "mask": mask.astype(np.float32)[None],  # [1,H,W]
        }


class CombinedDataset:
    """Zips VKITTI clips with Landmarks single-image samples by idx % len
    (Google_Landmark.py:78-111). Train items add image_* keys."""

    def __init__(self, video_dataset, google_image_root: str,
                 google_depth_root: str):
        self.video = video_dataset
        self.google = GoogleLandmarksDataset(
            image_root=google_image_root, depth_root=google_depth_root,
            clip_len=1, resize_size=video_dataset.resize_size)

    def __len__(self):
        return min(len(self.video), len(self.google))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        v = self.video[idx % len(self.video)]
        if self.video.split != "train":
            return v
        g = self.google[idx % len(self.google)]
        return {**v, "image_video": g["video"], "image_gt": g["gt"],
                "image_mask": g["mask"]}
