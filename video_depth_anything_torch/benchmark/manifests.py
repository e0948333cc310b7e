"""Benchmark manifests (the port's copy of the JAX package's
``benchmark/manifests.py``).

Schema: {dataset: [{seq_name: [{image, gt_depth, factor, K?, pose?}]}]},
read by ``benchmark/infer.py`` and ``benchmark/evaluate.py``. Depth
factors: kitti 256, nyuv2 6000, bonn 5000, sintel 65535/650, scannet 1000,
vkitti 100 (cm -> m).
"""
from __future__ import annotations

import glob
import json
import os.path as osp
import re

import numpy as np

DATASET_FACTORS = {
    "kitti": 256.0,
    "nyuv2": 6000.0,
    "bonn": 5000.0,
    "sintel": 65535 / 650,
    "scannet": 1000.0,
    "vkitti": 100.0,   # cm -> m (data/VKITTI.py:114-120)
}

_RGB_DIR = {"sintel": "clean", "scannet": "color"}


def natsorted(items):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
    return sorted(items, key=key)


def gen_json(root_path: str, dataset: str, start_id: int = 0, end_id: int = -1,
             step: int = 1, save_path: str | None = None) -> dict:
    factor = DATASET_FACTORS[dataset]
    rgb_name = _RGB_DIR.get(dataset, "rgb")
    data = {dataset: []}
    for piece in natsorted(glob.glob(osp.join(root_path, "*"))):
        if not osp.isdir(piece):
            continue
        name = osp.basename(piece)
        images = natsorted(glob.glob(osp.join(piece, rgb_name, "*.png"))
                           + glob.glob(osp.join(piece, rgb_name, "*.jpg")))
        depths = natsorted(glob.glob(osp.join(piece, "depth", "*.png"))
                           + glob.glob(osp.join(piece, "depth", "*.npy")))
        end = end_id if end_id >= 0 else None
        images = images[start_id:end:step]
        depths = depths[start_id:end:step]
        entries = [{
            "image": img[len(root_path) + 1:],
            "gt_depth": dep[len(root_path) + 1:],
            "factor": factor,
        } for img, dep in zip(images, depths)]
        data[dataset].append({name: entries})
    if save_path:
        with open(save_path, "w") as f:
            json.dump(data, f, indent=4)
    return data


def gen_json_scannet_tae(root_path: str, start_id: int = 0, end_id: int = -1,
                         step: int = 1, save_path: str | None = None) -> dict:
    """TAE manifest: adds per-frame K (intrinsic_depth.txt) and pose
    (eval_utils.py:65-107)."""
    data = {"scannet": []}
    color = "color_origin"
    for piece in natsorted(glob.glob(osp.join(root_path, "*"))):
        if not osp.isdir(piece):
            continue
        name = osp.basename(piece)
        images = natsorted(glob.glob(osp.join(piece, color, "*.jpg")))
        depths = natsorted(glob.glob(osp.join(piece, "depth", "*.png")))
        end = end_id if end_id >= 0 else None
        images = images[start_id:end:step]
        depths = depths[start_id:end:step]
        entries = []
        for img, dep in zip(images, depths):
            k = np.loadtxt(osp.join(osp.dirname(img).replace(color, "intrinsic"),
                                    "intrinsic_depth.txt"))
            pose = np.loadtxt(img.replace(color, "pose").replace(".jpg", ".txt"))
            entries.append({
                "image": img[len(root_path) + 1:],
                "gt_depth": dep[len(root_path) + 1:],
                "factor": 1000.0,
                "K": k.tolist(),
                "pose": pose.tolist(),
            })
        data["scannet"].append({name: entries})
    if save_path:
        with open(save_path, "w") as f:
            json.dump(data, f, indent=4)
    return data
