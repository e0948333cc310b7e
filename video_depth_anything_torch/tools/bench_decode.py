"""Host video-decode throughput: cv2 against the ffmpeg raw pipe.

    python -m video_depth_anything_torch.tools.bench_decode [video] [max_res]

The port of the JAX package's ``tools/bench_decode.py``, through the port's
``utils/video_io.py::read_video_frames``: the OpenCV backend
(``cv2.VideoCapture``, BGR -> RGB per frame on the consumer's core) against
the ffmpeg backend (decode, the fps stride and yuv -> rgb in an ffmpeg
subprocess through ``imageio_ffmpeg``; the consumer copies raw RGB24 from
the pipe, and resizes where ``max_res`` binds). It prints, per backend, the
frames, seconds and frames per second, then the pixel delta between the two
(their yuv -> rgb rounding differs).

With no video named it writes a seeded synthetic clip (``utils/
precision.py::synthetic_video``, 60 frames of 480x640 at 30 fps, OpenCV
mp4v) to a temporary file and removes it afterwards. A host tool: it needs
no card, but it needs both cv2 and imageio_ffmpeg (a missing ffmpeg backend
raises rather than decoding with cv2, so the A/B would not run), and it
exits non-zero, naming the missing module, without either.
"""
from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

CLIP_FRAMES, CLIP_HW, CLIP_FPS = 60, (480, 640), 30.0


def missing_module() -> str | None:
    """The first of cv2 and imageio_ffmpeg that cannot be imported."""
    for name in ("cv2", "imageio_ffmpeg"):
        try:
            if importlib.import_module(name) is None:
                return name
        except ImportError:
            return name
    return None


def write_clip(path: str, frames: int = CLIP_FRAMES, hw=CLIP_HW, fps: float = CLIP_FPS,
               seed: int = 3) -> None:
    """The seeded synthetic clip as an OpenCV mp4v file."""
    import cv2

    from ..utils.precision import synthetic_video

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (hw[1], hw[0]))
    try:
        for f in synthetic_video(frames, tuple(hw), seed):
            writer.write(np.ascontiguousarray(f[..., ::-1]))
    finally:
        writer.release()


def bench(video: str, backend: str, max_res: int = -1):
    """Decode ``video`` with ``backend``; print and return (frames, seconds)."""
    from ..utils.video_io import read_video_frames

    t0 = time.perf_counter()
    frames, _ = read_video_frames(video, -1, -1, max_res, decode_backend=backend)
    dt = time.perf_counter() - t0
    print(f"{backend:7s} {len(frames):5d} frames  {dt:7.2f} s  {len(frames) / dt:7.1f} fps  "
          f"{frames.shape[1]}x{frames.shape[2]}", flush=True)
    return frames, dt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    missing = missing_module()
    if missing is not None:
        print(f"bench_decode: the {missing} module is not installed; the cv2 / ffmpeg A/B "
              f"needs both cv2 and imageio_ffmpeg", file=sys.stderr)
        return 1
    max_res = int(argv[1]) if len(argv) > 1 else -1
    tmp = None
    if argv:
        video = argv[0]
    else:
        tmp = tempfile.mkdtemp(prefix="vda_decode_")
        video = os.path.join(tmp, "synthetic.mp4")
        write_clip(video)
        print(f"synthetic clip: {CLIP_FRAMES} frames {CLIP_HW[0]}x{CLIP_HW[1]} at {CLIP_FPS:g} "
              f"fps (mp4v)", flush=True)
    try:
        a, _ = bench(video, "cv2", max_res)
        b, _ = bench(video, "ffmpeg", max_res)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if a.shape == b.shape:
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        print(f"pixel delta: max {d.max()}  mean {d.mean():.4f} (yuv->rgb rounding differs "
              f"between libswscale and cv2)", flush=True)
    else:
        print(f"shape mismatch: {a.shape} vs {b.shape}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
