"""Virtual KITTI 2 video-clip dataset (the port's copy of the JAX
package's ``data/vkitti.py``).

NumPy and PIL (imported inside the functions): walks
vkitti_2.0.3_{rgb,depth,textgt} Scene*/condition/frames/.../Camera_{0,1};
Scene20 is the val split. Per clip: random contiguous clip_len frames
(Python ``random.Random(seed)``), one shared random square crop at
resize_size; rgb ImageNet-normalised; 16-bit depth png cm -> m with the
(0.001, 80) valid mask; disparity = 1 / depth normalised per frame to
[0, 1], quantised to 8 bits through a PIL "L" image when
quantize_disparity (the default), as the reference does.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil():
    from PIL import Image
    return Image


def resize_shorter_side(img, size: int, nearest: bool = False):
    """torchvision TF.resize(img, size) semantics: shorter side -> size."""
    Image = _pil()
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(int(round(h * size / w)), size)
    else:
        new_h, new_w = size, max(int(round(w * size / h)), size)
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return img.resize((new_w, new_h), resample)


def random_crop_params(img, output_size: int, rng: random.Random):
    w, h = img.size
    if w == output_size and h == output_size:
        return 0, 0, output_size, output_size
    i = rng.randint(0, h - output_size)
    j = rng.randint(0, w - output_size)
    return i, j, output_size, output_size


def _crop(img, i, j, th, tw):
    return img.crop((j, i, j + tw, i + th))


class VKITTIVideoDataset:
    """Returns dict batches (video [T,H,W,3], disparity [T,H,W],
    mask [T,H,W], + depth/extrinsics/intrinsics for val)."""

    def __init__(self, root_dir: str, clip_len: int = 32, resize_size: int = 518,
                 split: str = "train", min_depth: float = 0.001,
                 max_depth: float = 80.0, quantize_disparity: bool = True,
                 seed: int = 0):
        assert split in ("train", "val")
        self.clip_len = clip_len
        self.resize_size = resize_size
        self.split = split
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.quantize = quantize_disparity
        self.rng = random.Random(seed)

        rgb_root = os.path.join(root_dir, "vkitti_2.0.3_rgb")
        depth_root = os.path.join(root_dir, "vkitti_2.0.3_depth")
        textgt_root = os.path.join(root_dir, "vkitti_2.0.3_textgt")
        for p in (rgb_root, depth_root, textgt_root):
            if not os.path.isdir(p):
                raise FileNotFoundError(f"missing VKITTI folder: {p}")

        self.video_infos: List[Dict] = []
        for scene in sorted(os.listdir(rgb_root)):
            is_val_scene = "Scene20" in scene  # VKITTI.py:69-71
            if (split == "train") == is_val_scene:
                continue
            scene_rgb = os.path.join(rgb_root, scene)
            if not os.path.isdir(scene_rgb):
                continue
            for cond in sorted(os.listdir(scene_rgb)):
                intr = os.path.join(textgt_root, scene, cond, "intrinsic.txt")
                extr = os.path.join(textgt_root, scene, cond, "extrinsic.txt")
                if not (os.path.isfile(intr) and os.path.isfile(extr)):
                    continue
                for cam in ("Camera_0", "Camera_1"):
                    rgb_path = os.path.join(scene_rgb, cond, "frames", "rgb", cam)
                    dep_path = os.path.join(depth_root, scene, cond, "frames",
                                            "depth", cam)
                    if os.path.isdir(rgb_path) and os.path.isdir(dep_path):
                        self.video_infos.append(dict(
                            rgb_path=rgb_path, depth_path=dep_path,
                            intrinsic_file=intr, extrinsic_file=extr,
                            camera=int(cam[-1])))
        if not self.video_infos:
            raise ValueError(f"no video pairs for split {split}")

    def __len__(self):
        return len(self.video_infos)

    # -- internals -----------------------------------------------------------
    def _load_depth(self, path):
        """VKITTI.py:114-137: cm png -> disparity image + mask + metric depth."""
        Image = _pil()
        depth_cm = np.array(Image.open(path), np.uint16).astype(np.float32)
        depth_m = depth_cm / 100.0
        valid = (depth_m > self.min_depth) & (depth_m < self.max_depth)
        disp = np.zeros_like(depth_m)
        disp[valid] = 1.0 / depth_m[valid]
        lo, hi = disp.min(), disp.max()
        disp_norm = (disp - lo) / (hi - lo + 1e-8) if hi > lo else disp
        if self.quantize:
            disp_img = Image.fromarray((disp_norm * 255.0).astype(np.uint8),
                                       mode="L")
        else:
            disp_img = Image.fromarray(disp_norm, mode="F")
        mask_img = Image.fromarray((valid * 255).astype(np.uint8), mode="L")
        return disp_img, mask_img, depth_m

    @staticmethod
    def load_camera_params(intrinsic_path, extrinsic_path):
        """VKITTI.py:139-174 text parsers."""
        intrinsics = {}
        with open(intrinsic_path) as f:
            for line in f.readlines()[1:]:
                parts = line.split()
                if len(parts) < 6:
                    continue
                intrinsics[(int(parts[0]), int(parts[1]))] = \
                    [float(v) for v in parts[2:6]]
        extrinsics = {}
        with open(extrinsic_path) as f:
            for line in f.readlines()[1:]:
                parts = line.split()
                if len(parts) < 18:
                    continue
                extrinsics[(int(parts[0]), int(parts[1]))] = \
                    np.array([float(v) for v in parts[2:18]]).reshape(4, 4)
        return intrinsics, extrinsics

    # -- public --------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        Image = _pil()
        info = self.video_infos[idx]
        rgb_files = sorted(os.listdir(info["rgb_path"]))
        dep_files = sorted(os.listdir(info["depth_path"]))
        if len(rgb_files) != len(dep_files):
            raise ValueError("rgb/depth count mismatch")
        n = len(rgb_files)
        if n < self.clip_len:
            raise ValueError(f"clip_len {self.clip_len} > frames {n}")
        start = self.rng.randint(0, n - self.clip_len)

        first = Image.open(os.path.join(info["rgb_path"], rgb_files[start]))
        first = resize_shorter_side(first.convert("RGB"), self.resize_size)
        ci, cj, th, tw = random_crop_params(first, self.resize_size, self.rng)

        intr_d, extr_d = self.load_camera_params(info["intrinsic_file"],
                                                 info["extrinsic_file"])
        rgbs, disps, masks, depths, extrs, intrs = [], [], [], [], [], []
        for i in range(self.clip_len):
            fi = start + i
            frame_num = int(os.path.splitext(dep_files[fi].split("_")[-1])[0])

            img = Image.open(os.path.join(info["rgb_path"], rgb_files[fi]))
            img = _crop(resize_shorter_side(img.convert("RGB"),
                                            self.resize_size), ci, cj, th, tw)
            rgb = np.asarray(img, np.float32) / 255.0
            rgbs.append((rgb - IMAGENET_MEAN) / IMAGENET_STD)

            disp_img, mask_img, depth_m = self._load_depth(
                os.path.join(info["depth_path"], dep_files[fi]))
            disp_img = _crop(resize_shorter_side(disp_img, self.resize_size),
                             ci, cj, th, tw)
            disp = np.asarray(disp_img, np.float32)
            if self.quantize:
                disp = disp / 255.0  # to_tensor on uint8 (VKITTI.py:274)
            disps.append(disp)

            mask_img = _crop(resize_shorter_side(mask_img, self.resize_size,
                                                 nearest=True), ci, cj, th, tw)
            masks.append((np.asarray(mask_img, np.float32) > 0)
                         .astype(np.float32))

            dm = Image.fromarray(depth_m)
            dm = _crop(resize_shorter_side(dm, self.resize_size), ci, cj, th, tw)
            depths.append(np.asarray(dm, np.float32))

            extrs.append(extr_d.get((frame_num, info["camera"]),
                                    np.eye(4, dtype=np.float32)))
            ip = intr_d.get((frame_num, info["camera"]))
            if ip is None:
                ip = [725.0087, 725.0087, 620.5, 187.0]  # VKITTI.py:315-319
            fx, fy, cx, cy = ip
            intrs.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                                  np.float32))

        out = {
            "video": np.stack(rgbs),                    # [T,H,W,3]
            "gt": np.stack(disps),                      # [T,H,W] disparity
            "mask": np.stack(masks),                    # [T,H,W]
        }
        if self.split == "val":
            out["depth"] = np.stack(depths)
            out["extrinsics"] = np.stack(extrs).astype(np.float32)
            out["intrinsics"] = np.stack(intrs)
        return out
