"""Metric depth of a video -> one PLY point cloud per frame.

    python -m video_depth_anything_torch.depth_to_pointcloud \\
        --input_video clip.mp4 --encoder vitl --output_dir clouds

The metric model (``--checkpoint``, else ``./checkpoints/
metric_video_depth_anything_<encoder>.npz`` then ``.pth``, or
``--random_init``) runs the pipeline on ``--device`` (default cuda); each
frame's depth is unprojected through a pinhole camera with the principal
point at the image centre and focal lengths ``--focal-length-x / -y``
(default 470.4), coloured by the frame, and written as
``<output_dir>/point%04d.ply`` (binary little-endian, float xyz, uchar rgb).
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Video Depth Anything point clouds (PyTorch/CUDA)")
    parser.add_argument("--input_video", type=str,
                        default="./assets/example_videos/davis_rollercoaster.mp4")
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--max_res", type=int, default=1280)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"])
    parser.add_argument("--max_len", type=int, default=-1)
    parser.add_argument("--target_fps", type=int, default=-1)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--focal-length-x", default=470.4, type=float,
                        help="focal length along the x axis")
    parser.add_argument("--focal-length-y", default=470.4, type=float,
                        help="focal length along the y axis")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain path)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from . import run
    from .config import get_model_config
    from .pipeline import VideoDepthPipeline
    from .utils.pointcloud import unproject_depth, write_ply
    from .utils.video_io import read_video_frames

    run.probe_device(args.device)
    if args.fp32:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config(args.encoder, metric=True)
    model, _ = run.load_model(cfg, args.encoder, True, args.checkpoint, args.random_init,
                              args.device)
    frames, target_fps = read_video_frames(args.input_video, args.max_len, args.target_fps,
                                           args.max_res)
    pipe = VideoDepthPipeline(cfg, model, device=args.device)
    depths, _ = pipe.infer_video_depth(frames, target_fps, input_size=args.input_size,
                                       fp32=args.fp32)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, depth in enumerate(depths):
        points, colors = unproject_depth(depth, args.focal_length_x, args.focal_length_y,
                                         frames[i])
        write_ply(os.path.join(args.output_dir, f"point{i:04d}.ply"), points, colors)
    print(f"wrote {len(depths)} PLY point clouds to {args.output_dir}")


if __name__ == "__main__":
    main()
