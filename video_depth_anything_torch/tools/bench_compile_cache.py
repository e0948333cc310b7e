"""Card bench of the kernel build cache: a cold process against a warm one.

    python -m video_depth_anything_torch.tools.bench_compile_cache \\
        [--encoder vits] [--size 518] [--timeout 1800] [--json out.jsonl]

Runs this file twice as a fresh child process against one new temporary
cache directory (``utils/compile_cache.py``): the first finds it empty and
builds every kernel library with nvcc, the second loads them. Each child
reports the wall seconds of ``build.build_all()`` and of its first window
(``--encoder`` with random weights from seed 0, one window of 32 random
frames at ``--size``^2 through the pipeline, bf16, synchronised), and the
nvcc builds it ran; a child that runs past ``--timeout`` seconds fails the
bench. Prints one JSON line: ``cold_s`` and ``warm_s`` (build
plus first window), ``speedup``, each child's parts and builds, each
child's wall seconds as the parent saw them (interpreter start and CUDA
initialisation included), and the card's name and power limit. The warm
child must run no nvcc build. ``measure`` is chip_smoke.py's phase (q)
too. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(cache_dir: str, encoder: str, size: int) -> dict:
    """One process's cold start against ``cache_dir``."""
    import numpy as np
    import torch

    from ..config import get_model_config
    from ..kernels import build
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache(cache_dir)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    cfg = get_model_config(encoder)
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    frames = np.random.default_rng(0).integers(0, 256, size=(32, size, size, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    depth, _ = pipe.infer_video_depth(frames, input_size=size)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    return dict(build_s=build_s, first_window_s=window_s, nvcc_builds=len(build.build_log()),
                libraries=sorted(os.listdir(cache_dir)), finite=bool(np.isfinite(depth).all()))


def measure(cache_dir: str, encoder: str = "vits", size: int = 518,
            timeout: float = 1800.0) -> dict:
    """The cold and the warm child against ``cache_dir`` (module docstring)."""
    from .timing import card_line

    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "video_depth_anything_torch.tools."
                              "bench_compile_cache", "--child", cache_dir, "--encoder", encoder,
                              "--size", str(size)], capture_output=True, text=True, cwd=_ROOT,
                             timeout=timeout)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"bench_compile_cache child failed:\n{res.stdout}\n{res.stderr}")
        runs.append({**json.loads(res.stdout.strip().splitlines()[-1]), "process_s": wall})
    cold, warm = runs
    cold_s = cold["build_s"] + cold["first_window_s"]
    warm_s = warm["build_s"] + warm["first_window_s"]
    return dict(card=card_line(), encoder=encoder, size=size, cache_dir=cache_dir,
                cold_s=cold_s, warm_s=warm_s, speedup=cold_s / warm_s,
                cold_nvcc_builds=cold["nvcc_builds"], warm_nvcc_builds=warm["nvcc_builds"],
                cold=cold, warm=warm)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds each child process may run")
    ap.add_argument("--json", default=None, help="append the record to this JSON-lines file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_compile_cache: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.encoder, args.size)), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        rec = measure(tmp, args.encoder, args.size, args.timeout)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0 if rec["warm_nvcc_builds"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
