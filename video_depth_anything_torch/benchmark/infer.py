"""Batch benchmark inference (the port of the JAX package's
``benchmark/infer.py``).

Loads the model once, runs every manifest sequence through the port's
sliding-window pipeline (fp32, target_fps=1, BGR frames exactly as the
reference feeds cv2.imread output), and writes per-frame depth .npy files
mirroring the image paths. Runs on ``--device`` (default ``cuda``); cv2
reads the frames, so the machine needs it.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def infer_manifest(pipe, json_file: str, dataset: str, infer_path: str,
                   input_size: int = 518) -> int:
    import cv2

    with open(json_file) as f:
        manifest = json.load(f)
    root_path = os.path.dirname(json_file)
    n_seq = 0
    for seq in manifest[dataset]:
        for _, frames in seq.items():
            videos, out_paths = [], []
            for img in frames:
                out = os.path.join(infer_path, dataset, img["image"])
                out_paths.append(out.replace(".jpg", ".npy").replace(".png", ".npy"))
                # NOTE: reference feeds raw cv2.imread (BGR) frames
                # (infer.py:54-56) — reproduced for output parity.
                videos.append(cv2.imread(os.path.join(root_path, img["image"])))
            videos = np.stack(videos, axis=0)
            depths, _ = pipe.infer_video_depth(videos, target_fps=1,
                                               input_size=input_size, fp32=True)
            for path, depth in zip(out_paths, depths):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, depth)
            n_seq += 1
    return n_seq


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--infer_path", type=str, default="")
    parser.add_argument("--json_file", type=str, default="")
    parser.add_argument("--datasets", type=str, nargs="+", default=["scannet"])
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitl"])
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..config import get_model_config
    from ..convert import load_checkpoint
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline
    from ..utils.params_io import resolve_checkpoint

    cfg = get_model_config(args.encoder)
    ckpt = args.checkpoint or resolve_checkpoint(args.encoder)
    if ckpt is None:
        raise SystemExit(f"no checkpoint for {args.encoder} (use --checkpoint)")
    model = load_checkpoint(build_model(cfg, device=args.device), ckpt)
    pipe = VideoDepthPipeline(cfg, model, device=args.device)
    for ds in args.datasets:
        n = infer_manifest(pipe, args.json_file, ds, args.infer_path,
                           args.input_size)
        print(f"{ds}: {n} sequences")

if __name__ == "__main__":
    main()
