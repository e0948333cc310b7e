"""Benchmark dataset extractors (the port's copy of the JAX package's
``benchmark/extract.py``).

Each extractor lays a raw dataset out as {seq}/{rgb|clean|color,depth}/...
with the dataset's crop and writes its manifest (``manifests.gen_json``).
Crops: kitti / bonn to even sizes; nyuv2 [45:471, 41:601]; scannet
[8:-8, 11:-11]; sintel / vkitti none. Frame budgets: kitti 110, scannet
90 frames at step 3 plus 500 and TAE 192, ... PIL and cv2 are imported
inside the functions.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import shutil

import numpy as np

from .manifests import gen_json, gen_json_scannet_tae, natsorted

_SINTEL_TAG_FLOAT = 202021.25


def read_dpt(filename: str) -> np.ndarray:
    """Sintel .dpt float depth reader (dataset_extract_sintel.py:26-44)."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == _SINTEL_TAG_FLOAT, f"bad .dpt tag {check}"
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        assert 0 < width and 0 < height and width * height < 100_000_000
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width)


def _even(v: int) -> int:
    return v if v % 2 == 0 else v - 1


def _copy_crop(im_path, depth_path, out_img, out_depth, dataset):
    """copy_crop_files (eval_utils.py:120-139)."""
    import cv2
    from PIL import Image

    img = np.array(Image.open(im_path))
    if dataset in ("kitti", "bonn"):
        img = img[: _even(img.shape[0]), : _even(img.shape[1])]
    elif dataset == "nyuv2":
        img = img[45:471, 41:601, :]
    elif dataset == "scannet":
        img = img[8:-8, 11:-11, :]
    os.makedirs(osp.dirname(out_img), exist_ok=True)
    os.makedirs(osp.dirname(out_depth), exist_ok=True)
    cv2.imwrite(out_img, img)
    shutil.copyfile(depth_path, out_depth)


def _sorted_frames(path: str, suffix: str):
    names = [x for x in os.listdir(path) if x.endswith(suffix)]
    return sorted(names, key=lambda x: int(x.split(".")[0][-4:]))


def extract_kitti(root, depth_root, saved_dir, sample_len=-1):
    """proj_depth/groundtruth layout (dataset_extract_kitti.py:16-70)."""
    for seq in sorted(os.listdir(depth_root)):
        gt_dir = osp.join(depth_root, seq, "proj_depth/groundtruth/image_02")
        names = _sorted_frames(gt_dir, ".png")
        step = sample_len if sample_len > 0 else len(names)
        for s in range(0, len(names) - step + 1, step):
            for name in names[s:s + step]:
                _copy_crop(
                    osp.join(root, seq[:10], seq, "image_02/data", name),
                    osp.join(gt_dir, name),
                    osp.join(saved_dir, "kitti", seq, "rgb", name),
                    osp.join(saved_dir, "kitti", seq, "depth", name), "kitti")
    out = osp.join(saved_dir, "kitti")
    gen_json(out, "kitti", 0, 110, 1, osp.join(out, "kitti_video.json"))
    gen_json(out, "kitti", 0, 500, 1, osp.join(out, "kitti_video_500.json"))


def extract_bonn(root, depth_root, saved_dir, sample_len=-1):
    for seq in sorted(os.listdir(depth_root)):
        imgs = _sorted_frames(osp.join(depth_root, seq, "rgb"), ".png")
        deps = _sorted_frames(osp.join(depth_root, seq, "depth"), ".png")
        n = min(len(imgs), len(deps))
        step = sample_len if sample_len > 0 else n
        for s in range(0, n - step + 1, step):
            for i in range(s, s + step):
                _copy_crop(
                    osp.join(root, seq, "rgb", imgs[i]),
                    osp.join(depth_root, seq, "depth", deps[i]),
                    osp.join(saved_dir, "bonn", seq, "rgb", imgs[i]),
                    osp.join(saved_dir, "bonn", seq, "depth", deps[i]), "bonn")
    out = osp.join(saved_dir, "bonn")
    gen_json(out, "bonn", 30, 140, 1, osp.join(out, "bonn_video.json"))
    gen_json(out, "bonn", 30, 530, 1, osp.join(out, "bonn_video_500.json"))


def extract_sintel(root, depth_root, saved_dir, sample_len=-1):
    """Copies clean frames + converts .dpt to .npy depth
    (dataset_extract_sintel.py:47-110)."""
    for seq in sorted(os.listdir(root)):
        names = _sorted_frames(osp.join(root, seq), ".png")
        step = sample_len if sample_len > 0 else len(names)
        for s in range(0, len(names) - step + 1, step):
            for name in names[s:s + step]:
                out_img = osp.join(saved_dir, "sintel", seq, "clean", name)
                out_dep = osp.join(saved_dir, "sintel", seq, "depth",
                                   name[:-3] + "npy")
                os.makedirs(osp.dirname(out_img), exist_ok=True)
                os.makedirs(osp.dirname(out_dep), exist_ok=True)
                shutil.copyfile(osp.join(root, seq, name), out_img)
                np.save(out_dep, read_dpt(osp.join(depth_root, seq,
                                                   name[:-3] + "dpt")))
    out = osp.join(saved_dir, "sintel")
    gen_json(out, "sintel", 0, -1, 1, osp.join(out, "sintel_video.json"))


def extract_nyuv2(root, saved_dir, sample_len=-1):
    """NYUv2 sync'd rgb/depth with the 45:471,41:601 crop."""
    for seq in sorted(os.listdir(root)):
        rgb_dir = osp.join(root, seq, "rgb")
        dep_dir = osp.join(root, seq, "depth")
        if not (osp.isdir(rgb_dir) and osp.isdir(dep_dir)):
            continue
        imgs = natsorted(os.listdir(rgb_dir))
        deps = natsorted(os.listdir(dep_dir))
        for img, dep in zip(imgs, deps):
            _copy_crop(osp.join(rgb_dir, img), osp.join(dep_dir, dep),
                       osp.join(saved_dir, "nyuv2", seq, "rgb", img),
                       osp.join(saved_dir, "nyuv2", seq, "depth", dep), "nyuv2")
    out = osp.join(saved_dir, "nyuv2")
    gen_json(out, "nyuv2", 0, 110, 1, osp.join(out, "nyuv2_video.json"))
    gen_json(out, "nyuv2", 0, 500, 1, osp.join(out, "nyuv2_video_500.json"))


def extract_scannet(root, saved_dir, sample_len=-1):
    """Cropped color + depth, plus color_origin/intrinsic/pose for TAE
    (dataset_extract_scannet.py:15-115)."""
    for seq in sorted(os.listdir(root)):
        names = _sorted_frames(osp.join(root, seq, "color"), ".jpg")
        step = sample_len if sample_len > 0 else len(names)
        for s in range(0, len(names) - step + 1, step):
            for name in names[s:s + step]:
                dep = name[:-3] + "png"
                _copy_crop(osp.join(root, seq, "color", name),
                           osp.join(root, seq, "depth", dep),
                           osp.join(saved_dir, "scannet", seq, "color", name),
                           osp.join(saved_dir, "scannet", seq, "depth", dep),
                           "scannet")
                # TAE needs uncropped frames + poses.
                oimg = osp.join(saved_dir, "scannet", seq, "color_origin", name)
                os.makedirs(osp.dirname(oimg), exist_ok=True)
                shutil.copyfile(osp.join(root, seq, "color", name), oimg)
                pose_src = osp.join(root, seq, "pose", name[:-3] + "txt")
                if osp.exists(pose_src):
                    opose = osp.join(saved_dir, "scannet", seq, "pose",
                                     name[:-3] + "txt")
                    os.makedirs(osp.dirname(opose), exist_ok=True)
                    shutil.copyfile(pose_src, opose)
        intr = osp.join(root, seq, "intrinsic", "intrinsic_depth.txt")
        if osp.exists(intr):
            ointr = osp.join(saved_dir, "scannet", seq, "intrinsic",
                             "intrinsic_depth.txt")
            os.makedirs(osp.dirname(ointr), exist_ok=True)
            shutil.copyfile(intr, ointr)
    out = osp.join(saved_dir, "scannet")
    gen_json(out, "scannet", 0, 90 * 3, 3, osp.join(out, "scannet_video.json"))
    gen_json(out, "scannet", 0, 500, 1, osp.join(out, "scannet_video_500.json"))
    gen_json_scannet_tae(out, 0, 192, 1, osp.join(out, "scannet_video_tae.json"))


def extract_vkitti(root, saved_dir, eval_scene="Scene20"):
    """Virtual KITTI 2 eval split = Scene20 (dataset_extract_vkitti.py:17-203,
    matching data/VKITTI.py:69-71's val split)."""
    rgb_root = osp.join(root, "vkitti_2.0.3_rgb", eval_scene)
    dep_root = osp.join(root, "vkitti_2.0.3_depth", eval_scene)
    for cond in sorted(os.listdir(rgb_root)):
        for cam in ("Camera_0", "Camera_1"):
            rgb_dir = osp.join(rgb_root, cond, "frames", "rgb", cam)
            dep_dir = osp.join(dep_root, cond, "frames", "depth", cam)
            if not osp.isdir(rgb_dir):
                continue
            imgs = natsorted(glob.glob(osp.join(rgb_dir, "*.jpg")))
            deps = natsorted(glob.glob(osp.join(dep_dir, "*.png")))
            n = min(len(imgs), len(deps))
            seq = f"{eval_scene}_{cond}_{cam}"
            for img, dep in zip(imgs[:n], deps[:n]):
                out_img = osp.join(saved_dir, "vkitti", seq, "rgb",
                                   osp.basename(img))
                out_dep = osp.join(saved_dir, "vkitti", seq, "depth",
                                   osp.basename(dep))
                os.makedirs(osp.dirname(out_img), exist_ok=True)
                os.makedirs(osp.dirname(out_dep), exist_ok=True)
                shutil.copyfile(img, out_img)
                shutil.copyfile(dep, out_dep)
    out = osp.join(saved_dir, "vkitti")
    gen_json(out, "vkitti", 0, 110, 1, osp.join(out, "vkitti_video.json"))


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", choices=["kitti", "bonn", "sintel",
                                            "nyuv2", "scannet", "vkitti"])
    parser.add_argument("--root", required=True)
    parser.add_argument("--depth_root", default=None)
    parser.add_argument("--saved_dir", required=True)
    parser.add_argument("--sample_len", type=int, default=-1)
    args = parser.parse_args(argv)
    fn = {
        "kitti": lambda: extract_kitti(args.root, args.depth_root,
                                       args.saved_dir, args.sample_len),
        "bonn": lambda: extract_bonn(args.root, args.depth_root or args.root,
                                     args.saved_dir, args.sample_len),
        "sintel": lambda: extract_sintel(args.root, args.depth_root,
                                         args.saved_dir, args.sample_len),
        "nyuv2": lambda: extract_nyuv2(args.root, args.saved_dir,
                                       args.sample_len),
        "scannet": lambda: extract_scannet(args.root, args.saved_dir,
                                           args.sample_len),
        "vkitti": lambda: extract_vkitti(args.root, args.saved_dir),
    }[args.dataset]
    fn()


if __name__ == "__main__":
    main()
