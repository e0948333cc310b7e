"""Video Depth Anything on PyTorch/CUDA: relative (or metric) depth of one
video.

    python -m video_depth_anything_torch.run --input_video clip.mp4 \\
        --encoder vits --checkpoint video_depth_anything_vits.pth

Writes ``<stem>_src.mp4``, ``<stem>_vis.mp4`` and, with ``--save_npz``,
``<stem>_depths.npz`` ([N, H, W] float32), with ``--save_exr`` one ZIP EXR
per frame in ``<stem>_depths_exr/frame_%05d.exr``, to ``--output_dir``.
Runs on ``--device`` (default ``cuda``; the card must answer a probe
within ``VDA_DEVICE_TIMEOUT`` seconds, default 90, 0 skips it); ``--device
cpu`` takes the plain PyTorch path. ``--checkpoint`` takes a reference
``.pth`` or the JAX package's ``.npz``; without it the lookup is
``./checkpoints/[metric_]video_depth_anything_<encoder>.npz``, then
``.pth``. ``--int8`` runs the w8a8 model, its activation scales calibrated on
the first window and kept in ``<checkpoint>.int8calib.npz``.
``--windows_per_batch C`` runs C windows per device step (the batched
keyframe cache); ``--streaming`` decodes on a background thread, encodes
``_src.mp4`` as frames go by and spills depth chunks to a disk spool, so
host memory stays bounded for any video length, with the same outputs as
the batch run; ``--transfer_fp16`` brings depths back to the host as fp16.
The three compose with each other and with ``--int8``. Decoding and
writing need OpenCV; ``--decode_backend ffmpeg`` (or
``VDA_DECODE_BACKEND=ffmpeg``) decodes in an ffmpeg subprocess through
imageio_ffmpeg.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Video Depth Anything (PyTorch/CUDA)")
    parser.add_argument("--input_video", type=str,
                        default="./assets/example_videos/davis_rollercoaster.mp4")
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--max_res", type=int, default=1280)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg"],
                        help="vits / vitl have released checkpoints; vitb / vitg "
                             "follow the DINOv2 factory (vitg: fused SwiGLU FFN)")
    parser.add_argument("--max_len", type=int, default=-1,
                        help="maximum number of input frames, -1 = no limit")
    parser.add_argument("--target_fps", type=int, default=-1,
                        help="target fps, -1 = original")
    parser.add_argument("--fp32", action="store_true",
                        help="infer in float32 (default bfloat16)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 encoder and motion-module linears (w8a8, "
                             "calibrated on the first window; ops/quant.py). "
                             "Scales persist as <checkpoint>.int8calib.npz, so "
                             "calibration runs once per checkpoint and geometry")
    parser.add_argument("--grayscale", action="store_true",
                        help="no color palette in the depth video")
    parser.add_argument("--save_npz", action="store_true")
    parser.add_argument("--save_exr", action="store_true",
                        help="one ZIP-compressed single-channel EXR per frame in "
                             "<stem>_depths_exr/")
    parser.add_argument("--metric", action="store_true",
                        help="metric-depth model (identity window stitching)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference .pth state_dict or the JAX package's .npz; "
                             "defaults to ./checkpoints/[metric_]video_depth_anything_"
                             "<encoder>.npz, then .pth")
    parser.add_argument("--random_init", action="store_true",
                        help="random weights (smoke testing without a checkpoint)")
    parser.add_argument("--windows_per_batch", type=int, default=1,
                        help="windows per device step: C > 1 encodes each source "
                             "frame of a chunk of C windows once and runs the head "
                             "on [C, 32] (the batched keyframe cache)")
    parser.add_argument("--streaming", action="store_true",
                        help="bounded host memory: background decode, _src.mp4 "
                             "written incrementally, depth chunks spilled to "
                             "<stem>_depths.spool.f32 with their exact running "
                             "range (removed at the end); outputs equal the "
                             "batch run's bit for bit")
    parser.add_argument("--transfer_fp16", action="store_true",
                        help="depths cross from the device to the host as fp16 "
                             "(half the download bytes); compute and stitching "
                             "stay as they are, outputs are float32 within 2^-11 "
                             "of each value")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the decode, the "
                             "inference and the _src.mp4 write to <dir>/trace.json")
    parser.add_argument("--decode_backend", type=str, default=None, choices=["cv2", "ffmpeg"],
                        help="video decode backend (default cv2, or VDA_DECODE_BACKEND); "
                             "ffmpeg needs imageio_ffmpeg")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain path)")
    return parser.parse_args(argv)


def probe_device(device: str) -> None:
    """Exit with a message unless a CUDA device answers within
    ``VDA_DEVICE_TIMEOUT`` seconds (default 90; 0 skips the probe)."""
    import torch

    from .utils.platform_env import device_unreachable

    budget = float(os.environ.get("VDA_DEVICE_TIMEOUT", "90"))
    if torch.device(device).type != "cuda" or budget == 0:
        return
    err = device_unreachable(budget)
    if err is not None:
        print(f"CUDA device unavailable: {err}\n(set VDA_DEVICE_TIMEOUT to adjust the "
              f"probe budget, 0 to skip; --device cpu runs the plain path)",
              file=sys.stderr, flush=True)
        os._exit(1)   # the probe thread may still be stuck in the driver


def load_model(cfg, encoder: str, metric: bool, checkpoint: str | None, random_init: bool,
               device: str):
    """(model on ``device``, checkpoint path or None): the checkpoint named
    or found by the default lookup (``.npz`` before ``.pth``), else seeded
    random weights drawn on the device when ``random_init``, else exit."""
    from .convert import load_checkpoint
    from .models import build_model
    from .utils.params_io import resolve_checkpoint

    ckpt = checkpoint or resolve_checkpoint(encoder, metric)
    if ckpt is not None and os.path.exists(ckpt):
        print(f"loading checkpoint: {ckpt}")
        return load_checkpoint(build_model(cfg, device=device), ckpt), ckpt
    if random_init:
        print("WARNING: --random_init — outputs are not meaningful depth")
        return build_model(cfg, seed=0, device=device), None
    prefix = "metric_video_depth_anything" if metric else "video_depth_anything"
    sys.exit(f"no checkpoint at {ckpt or f'./checkpoints/{prefix}_{encoder}.npz or .pth'} "
             f"(use --checkpoint or --random_init)")


def write_exr_frames(depths, out: str) -> None:
    """``<out>_depths_exr/frame_%05d.exr``, ZIP, in chunks of 64 frames, so
    the host holds one chunk when ``depths`` is the spool's memmap."""
    from .utils.exr import write_exr_batch

    exr_dir = out + "_depths_exr"
    os.makedirs(exr_dir, exist_ok=True)
    paths = [os.path.join(exr_dir, f"frame_{i:05d}.exr") for i in range(len(depths))]
    for i in range(0, len(depths), 64):
        write_exr_batch(paths[i:i + 64], depths[i:i + 64], compression="zip")
    print(f"wrote {len(depths)} EXR frames to {exr_dir}")


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    probe_device(args.device)

    from .config import get_model_config
    from .pipeline import VideoDepthPipeline
    from .utils import profiling, video_io

    if args.fp32:  # true fp32: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config(args.encoder, metric=args.metric)
    model, ckpt = load_model(cfg, args.encoder, args.metric, args.checkpoint, args.random_init,
                             args.device)

    # int8 scales persist next to the checkpoint; random weights calibrate
    # every run.
    calib_path = ckpt + ".int8calib.npz" if (args.int8 and ckpt) else None
    pipe = VideoDepthPipeline(cfg, model, device=args.device,
                              quant="int8" if args.int8 else None,
                              calib_path=calib_path, transfer_fp16=args.transfer_fp16)
    os.makedirs(args.output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.input_video))[0]
    out = os.path.join(args.output_dir, stem)
    spool = None
    with profiling.trace(args.profile_dir):
        if args.streaming:
            it, fps, hw = video_io.stream_video_frames(args.input_video, args.max_len,
                                                       args.target_fps, args.max_res,
                                                       decode_backend=args.decode_backend)
            print(f"streaming {hw[0]}x{hw[1]} @ {fps:.2f} fps, device={pipe.device}")

            def tee(frames):   # _src.mp4 is written as the frames go by
                with video_io.IncrementalVideoWriter(out + "_src.mp4", fps) as writer:
                    for f in frames:
                        writer.append(f)
                        yield f

            spool = video_io.DepthSpool(out + "_depths.spool.f32")
            try:
                for chunk in pipe.infer_video_depth_streaming(
                        tee(it), input_size=args.input_size, fp32=args.fp32,
                        windows_per_batch=args.windows_per_batch):
                    spool.append(chunk)
                if spool.count == 0:
                    raise ValueError(f"no frames decoded from {args.input_video}")
            except BaseException:
                it.close()        # stop the decoder
                spool.cleanup()   # no spill file left behind by a failed run
                raise
            depths = spool.finish()
        else:
            frames, target_fps = video_io.read_video_frames(args.input_video, args.max_len,
                                                            args.target_fps, args.max_res,
                                                            decode_backend=args.decode_backend)
            print(f"{frames.shape[0]} frames @ {target_fps:.2f} fps, "
                  f"{frames.shape[1]}x{frames.shape[2]}, device={pipe.device}")
            depths, fps = pipe.infer_video_depth(frames, target_fps, input_size=args.input_size,
                                                 fp32=args.fp32,
                                                 windows_per_batch=args.windows_per_batch)
            video_io.save_video(frames, out + "_src.mp4", fps=fps)
            del frames
    try:
        if spool is not None:   # encoded block by block from the spool's memmap
            video_io.save_depth_video_streamed(depths, out + "_vis.mp4", fps,
                                               (spool.min, spool.max), grayscale=args.grayscale)
        else:
            video_io.save_video(depths, out + "_vis.mp4", fps=fps, is_depths=True,
                                grayscale=args.grayscale)
        print(f"wrote {out}_src.mp4 and _vis.mp4")
        if args.save_npz:
            np.savez_compressed(out + "_depths.npz", depths=depths)
            print(f"wrote {stem}_depths.npz")
        if args.save_exr:
            write_exr_frames(depths, out)
    finally:
        if spool is not None:
            del depths   # the memmap goes before its file
            spool.cleanup()


if __name__ == "__main__":
    main()
