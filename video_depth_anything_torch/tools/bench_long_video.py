"""Card bench of the long-video path: wall ms per frame of the pipeline's
modes on one synthetic video.

    python -m video_depth_anything_torch.tools.bench_long_video \\
        [--encoder vits] [--frames 400] [--repeats 3] [--label new] [--json out.jsonl]

For each mode -- the sequential keyframe cache, the same with blocking
copies (``HostLink(overlap=False)``), the batched cache at C = 2 and 4,
streaming at C = 1 and 4 -- one warm call, then ``--repeats`` timed calls
on the host clock (a call returns host arrays, so it ends synchronised),
their median per frame, the peak device memory, and one more call under
torch.profiler: the kernels' busy time, the copies' time and the idle
share (1 - busy / wall, the profiler on; a busy time over the wall time
shows as a negative share). bf16, random weights from seed 0, a seeded
480x640 video (the reference's default input size 518: 518x686). One
JSON line per mode, with the card's name and power limit. ``modes`` and
``measure`` are chip_smoke.py's long-video timings too.

A tree whose pipeline has no ``windows_per_batch`` runs the sequential
mode alone, so an older tree can be timed by this file's path from its own
root (``cd old && python $ROOT/video_depth_anything_torch/tools/...``) in
the same call as the new one. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import os
import statistics
import sys
import time

import torch

if __package__ in (None, ""):   # run by path: the package of the working directory
    sys.path.insert(0, os.getcwd())


def profiled(call) -> tuple[float, float, float]:
    """(host wall ms, kernels' busy ms, copies' ms) of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = copies = 0.0
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if e.key.startswith(("Memcpy", "Memset")):
            copies += ms
        else:
            busy += ms
    return wall, busy, copies


@contextlib.contextmanager
def blocking_copies():
    """The pipeline with every host <-> device copy blocking."""
    from video_depth_anything_torch.pipeline import infer

    link = infer.HostLink
    infer.HostLink = functools.partial(link, overlap=False)
    try:
        yield
    finally:
        infer.HostLink = link


def modes(pipe, frames) -> dict:
    """The timed calls by mode name; the sequential mode alone on a tree
    whose pipeline has no ``windows_per_batch``."""
    def stream(c):
        return lambda: list(pipe.infer_video_depth_streaming(iter(frames), windows_per_batch=c))

    def blocking():
        with blocking_copies():
            return pipe.infer_video_depth(frames)

    out = {"sequential": lambda: pipe.infer_video_depth(frames)}
    if "windows_per_batch" in inspect.signature(pipe.infer_video_depth).parameters:
        out.update({
            "sequential, blocking copies": blocking,
            "C=2": lambda: pipe.infer_video_depth(frames, windows_per_batch=2),
            "C=4": lambda: pipe.infer_video_depth(frames, windows_per_batch=4),
            "streaming C=1": stream(1), "streaming C=4": stream(4)})
    return out


def measure(call, n_frames: int, repeats: int) -> dict:
    """One warm call, ``repeats`` timed calls (their median ms per frame),
    the peak device memory, then one call under the profiler."""
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        call()
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy, copies = profiled(call)
    return dict(ms_per_frame=statistics.median(walls) / n_frames,
                ms_per_frame_runs=[w / n_frames for w in walls], peak_gib=peak,
                profiled_wall_ms=wall, kernel_busy_ms=busy, copy_ms=copies,
                idle_share=1 - busy / wall)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl"])
    parser.add_argument("--frames", type=int, default=400)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--label", default="")
    parser.add_argument("--json", default=None, help="append the rows to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_long_video: no CUDA device", file=sys.stderr)
        return 2
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.tools.timing import card_line
    from video_depth_anything_torch.utils.precision import synthetic_video

    cfg = get_model_config(args.encoder)
    frames = synthetic_video(n=args.frames, hw=(480, 640), seed=3)
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    card = card_line()
    rows = []
    for name, call in modes(pipe, frames).items():
        row = dict(label=args.label, mode=name, encoder=args.encoder, frames=args.frames,
                   hw=[480, 640], **measure(call, args.frames, args.repeats), card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
