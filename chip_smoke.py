#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (video_depth_anything_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero,
printing no result, without either. Phases, each fatal on failure:

  (a) environment: card name and power limit, torch and CUDA versions;
      TF32 is switched off for matmuls and cuDNN, so fp32 phases are true
      fp32.
  (b) build: nvcc builds every kernel from csrc/ (in parallel).
  (c) K1 spatial attention against its plain version, bf16 and fp32, at
      the encoders' shapes (strided views of a fused qkv, as the model
      passes them).
  (c') K3 int8-QK spatial attention against its plain version, bf16 and
      fp32 v, at the same shapes (random int8 q and k, v a column view of
      a fused qkv), and its odd-head fallback (K1 on dequantized q, k).
  (d) K2 temporal attention against its plain version at every motion
      module shape of vits and vitl at 518x518 and of vits at 518x686 (the
      main path's), T = 32 and T = 4.
  (e) the main path: VideoDepthPipeline.infer_video_depth, vits at full
      width with seeded random weights, on a 100-frame 480x640 synthetic
      video (5 windows at 518x686), bf16 with the keyframe cache. Launch
      counts are read around this run; then bf16 is held against fp32 on
      the card (drift budget), and the card's fp32 run of a reduced clip
      against the port's plain path on the CPU.
  (e') the int8 main path: the same video through
      VideoDepthPipeline(quant="int8", calib_path=...), twice: the first
      call calibrates and writes the side file, the second (a new
      pipeline) reads it; launch counts are read around each call. int8
      is held against the card's fp32 output within the int8 drift
      budget, and the card's int8 run of the reduced clip against the CPU
      plain int8 run on the same side file.
  (f) timing: one window forward at 1x32x518x518 in bf16 and in int8,
      vits and vitl, and the cached steady state per new frame for vits;
      then a torch.profiler breakdown of the vits window by kernel kind,
      bf16 and int8.
  (g) one JSON line {"kernels": [...]}, then the card's name and power
      limit, then the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12               # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core bf16
              "float32": 67e12}         # fp32 outside the tensor cores (no TF32)
PEAK_INT8_OPS = 1979e12                 # dense tensor-core int8
# Max abs error against the plain version. The spatial kernels' outputs
# are near-uniform averages of unit-normal v over 1370-1814 keys (mean |o|
# about 0.03, max 0.2 to 0.7), so bf16 is held to 4e-3: a few times the
# bf16 rounding seen (1e-3 to 2e-3), below what a dropped key tile or one
# head's mis-scaled softmax gives (5e-2 and up). K2 averages over at most
# 32 frames: outputs of order 1, where a bf16 step is 4e-3 to 1.6e-2.
TOL = {"spatial_attention": {"bfloat16": 4e-3, "float32": 1e-4},
       "spatial_attention_qk8": {"bfloat16": 4e-3, "float32": 1e-4},
       "temporal_attention": {"bfloat16": 2e-2, "float32": 1e-4}}


def held(kernel, name, got, ref):
    """(max abs error, its tolerance, whether it holds, and a print of the
    error beside the reference's own size)."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    tol = TOL[kernel][name]
    ok = err <= tol and bool(torch.isfinite(got).all())
    return err, ok, (f"max_abs_err {err:.3e} (tol {tol:g}; reference mean |o| "
                     f"{ref.float().abs().mean().item():.3e}, max |o| "
                     f"{ref.float().abs().max().item():.3e})")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_k1(gen, record):
    """K1 at the encoder shapes; returns the main-path entry's numbers."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch.kernels import spatial_attention as k1

    shapes = [("vits 518^2", 32, 1370, 6), ("vitl 518^2", 32, 1370, 16),
              ("vits 518x686 cached", 22, 1814, 6)]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, b, s, h in shapes:
            c = h * 64
            qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            cases = [("strided qkv", q, k, v)]
            if label.startswith("vits 518^2"):
                cases.append(("contiguous", q.contiguous(), k.contiguous(), v.contiguous()))
            for layout, qq, kk, vv in cases:
                got = k1.spatial_attention(qq, kk, vv, num_heads=h, scale=0.125)
                ref = k1.spatial_attention_plain(qq, kk, vv, num_heads=h, scale=0.125)
                torch.cuda.synchronize()
                err, ok, said = held("spatial_attention", name, got, ref)
                iters = 5 if name == "float32" else 20
                ms = time_ms(lambda: k1.spatial_attention(qq, kk, vv, num_heads=h, scale=0.125), iters)
                plain = time_ms(lambda: k1.spatial_attention_plain(qq, kk, vv, num_heads=h, scale=0.125), 3, 1)
                heads = [t.unflatten(-1, (h, 64)).transpose(1, 2) for t in (qq, kk, vv)]
                lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=0.125), iters)
                bms, by = bound_ms(4 * b * h * s * s * 64, 4 * b * s * c * qq.element_size(), name)
                print(f"K1 {name:8s} {label:20s} {layout:11s} [{b},{s},{c}] H={h}: "
                      f"{said} kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms, "
                      f"bound {bms:.4f} ms ({by})", flush=True)
                if not ok:
                    raise AssertionError(f"K1 {name} {label} {layout}: {said}")
                record("spatial_attention", name, err)
                if name == "bfloat16" and label.endswith("cached") and layout == "strided qkv":
                    main = dict(shape=[b, s, c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=bms, bound_by=by)
            del qkv, q, k, v
    return main


def check_k3(gen, record):
    """K3 at the encoder shapes and the odd-head fallback; returns the
    main-path entry's numbers."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3

    # (amax_q / 127 * dh^-0.5, amax_k / 127) for |q|, |k| up to about 1.6:
    # logits of a few units on random int8.
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    shapes = [("vits 518^2", 32, 1370, 6), ("vitl 518^2", 32, 1370, 16),
              ("vits 518x686 cached", 22, 1814, 6)]
    main = None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, b, s, h in shapes:
            c = h * 64
            q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=gen,
                                    dtype=torch.int8) for _ in range(2))
            qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
            v = qkv[..., 2 * c:]
            got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h)
            ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h)
            torch.cuda.synchronize()
            err, ok, said = held("spatial_attention_qk8", name, got, ref)
            ok = ok and got.dtype == dt
            iters = 5 if name == "float32" else 20
            ms = time_ms(lambda: k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h), iters)
            plain = time_ms(lambda: k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h), 3, 1)
            # SDPA on q and k dequantized to v's dtype: the same function up
            # to the int8 rounding of the scores.
            heads = [t.unflatten(-1, (h, 64)).transpose(1, 2)
                     for t in (q8.to(dt) * scales[0].to(dt), k8.to(dt) * scales[1].to(dt), v)]
            lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), iters)
            ops = 2 * b * h * s * s * 64
            t_ops = ops / PEAK_INT8_OPS + ops / PEAK_FLOPS[name]
            t_bytes = b * s * c * (2 + 2 * v.element_size()) / HBM_BYTES_PER_S
            bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
            print(f"K3 {name:8s} {label:20s} [{b},{s},{c}] H={h}: {said} kernel {ms:.3f} ms, "
                  f"plain {plain:.3f} ms, sdpa {lib:.3f} ms, bound {bms:.4f} ms ({by})",
                  flush=True)
            if not ok:
                raise AssertionError(f"K3 {name} {label}: {said}, dtype {got.dtype}")
            record("spatial_attention_qk8", name, err)
            if name == "bfloat16" and label.endswith("cached"):
                main = dict(shape=[b, s, c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bms, bound_by=by)
            del q8, k8, qkv, v, got, ref, heads
            torch.cuda.empty_cache()
        # Odd H cannot pair heads: q, k dequantize into K1 at scale 1, as
        # in the JAX package; held against K1's plain version on the same
        # dequantized q, k.
        q8, k8 = (torch.randint(-127, 128, (2, 300, 192), device="cuda", generator=gen,
                                dtype=torch.int8) for _ in range(2))
        v = torch.randn(2, 300, 192, device="cuda", generator=gen).to(dt)
        kernels.reset_launch_counts()
        got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=3)
        counts = kernels.launch_counts()
        ref = k1.spatial_attention_plain(q8.to(dt) * scales[0].to(dt), k8.to(dt) * scales[1].to(dt),
                                         v, num_heads=3, scale=1.0)
        err, ok, said = held("spatial_attention", name, got, ref)
        print(f"K3 {name:8s} odd-H fallback [2,300,192] H=3: {said} against K1's plain "
              f"version; launches {counts}", flush=True)
        if not (ok and counts["spatial_attention"] == 1 and counts["spatial_attention_qk8"] == 0):
            raise AssertionError(f"K3 {name} fallback: {said}, launches {counts}")
    return main


def check_k2(gen, record):
    """K2 at every motion-module shape; returns the main-path entry's numbers."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch.kernels import temporal_attention as k2

    # (pixels per window, C) of motion modules 0..3; the main path of (e)
    # runs vits at 518x686 (37x49 patches).
    modules = {"vits 518^2": [(37 * 37, 192), (19 * 19, 384), (37 * 37, 64), (74 * 74, 64)],
               "vitl 518^2": [(37 * 37, 1024), (19 * 19, 1024), (37 * 37, 256), (74 * 74, 256)],
               "vits 518x686": [(37 * 49, 192), (19 * 25, 384), (37 * 49, 64), (74 * 98, 64)]}
    main = None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for enc, shapes in modules.items():
            for mod, (p, c) in enumerate(shapes):
                for t in (32, 4):
                    dh = c // 8
                    q, k, v = (torch.randn(p, t, c, device="cuda", generator=gen).to(dt)
                               for _ in range(3))
                    got = k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5)
                    ref = k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5)
                    torch.cuda.synchronize()
                    err, ok, said = held("temporal_attention", name, got, ref)
                    line = f"K2 {name:8s} {enc:12s} module {mod} [{p},{t},{c}] dh={dh}: {said}"
                    if t == 32:
                        ms = time_ms(lambda: k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5), 20)
                        plain = time_ms(lambda: k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5), 5, 1)
                        heads = [x.unflatten(-1, (8, dh)).transpose(1, 2) for x in (q, k, v)]
                        lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=dh ** -0.5), 20)
                        bms, by = bound_ms(4 * p * t * t * c, 4 * p * t * c * q.element_size(), name)
                        line += (f" kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                                 f"bound {bms:.4f} ms ({by})")
                        if name == "bfloat16" and enc == "vits 518x686" and mod == 3:
                            main = dict(shape=[p, t, c], heads=8, dtype=name, ms=ms,
                                        plain_ms=plain, library_ms=lib, bound_ms=bms,
                                        bound_by=by)
                    print(line, flush=True)
                    if not ok:
                        raise AssertionError(f"K2 {name} {enc} module {mod} T={t}: {said}")
                    record("temporal_attention", name, err)
    return main


def main_path(cardname):
    """(e): the port's pipeline, vits at full width, on the card."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.utils.precision import (
        MAX_ERR_FRAC, MEAN_ERR_FRAC, precision_drift_report, synthetic_video)

    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0, device="cuda")
    pipe = VideoDepthPipeline(cfg, model)       # no device given: the card
    frames = synthetic_video(n=100, hw=(480, 640), seed=3)
    n_win = num_windows(len(frames))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    d16, _ = pipe.infer_video_depth(frames)       # bf16, keyframe cache
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"main path: vits bf16 cached, {len(frames)} frames 480x640 -> 518x686, "
          f"{n_win} windows in {wall:.3f} s (first call, includes warm-up) on {cardname}; "
          f"launches {launches}", flush=True)
    if d16.shape != frames.shape[:3] or not np.isfinite(d16).all():
        raise AssertionError(f"bad output: shape {d16.shape}, finite {np.isfinite(d16).all()}")
    want = {"spatial_attention": cfg.vit.depth * n_win,   # 12 per encode
            "temporal_attention": 8 * n_win,                # 4 modules x 2 blocks
            "spatial_attention_qk8": 0}                     # int8 only
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    d32, _ = pipe.infer_video_depth(frames, fp32=True)
    rep = precision_drift_report(d16, d32)
    print(f"bf16 vs fp32 on the card: max {rep['max_err_frac']:.5f} / mean "
          f"{rep['mean_err_frac']:.6f} of depth range {rep['depth_range']:.4f} "
          f"(budget {MAX_ERR_FRAC} / {MEAN_ERR_FRAC})", flush=True)
    if not (rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC):
        raise AssertionError(f"bf16 drift over budget: {rep}")

    small = synthetic_video(n=40, hw=(140, 196), seed=5)
    g32, _ = pipe.infer_video_depth(small, input_size=112, fp32=True)
    cpu = VideoDepthPipeline(cfg, copy.deepcopy(model).to("cpu"), device="cpu")
    c32, _ = cpu.infer_video_depth(small, input_size=112, fp32=True)
    rng = float(c32.max() - c32.min())
    err = float(np.abs(g32 - c32).max()) / max(rng, 1e-12)
    print(f"card fp32 vs CPU plain path, 40 frames 140x196 (input 112): max "
          f"{err:.3e} of depth range {rng:.4f} (tol 1e-3)", flush=True)
    if not err < 1e-3:
        raise AssertionError(f"card fp32 vs CPU plain path: {err}")
    del pipe, cpu
    return launches, d32


def int8_path(cardname, d32):
    """(e'): the port's --int8 pipeline, vits at full width, on the card:
    a first call that calibrates and writes the side file, a second (new
    pipeline) that reads it. Returns the first call's launch counts."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.utils.precision import (
        INT8_MAX_ERR_FRAC, INT8_MEAN_ERR_FRAC, flip_floor_report, precision_drift_report,
        synthetic_video)

    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0, device="cuda")
    frames = synthetic_video(n=100, hw=(480, 640), seed=3)
    n_win = num_windows(len(frames))
    depth = cfg.vit.depth
    tmp = tempfile.mkdtemp(prefix="vda_int8_")
    try:
        path = os.path.join(tmp, "vits.int8calib.npz")
        runs = []
        for call in ("first (calibrates)", "second (reads the side file)"):
            pipe = VideoDepthPipeline(cfg, model, quant="int8", calib_path=path)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            d8, _ = pipe.infer_video_depth(frames)      # bf16, keyframe cache
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            print(f"int8 main path, {call}: vits bf16 cached, {len(frames)} frames 480x640 "
                  f"-> 518x686, {n_win} windows in {wall:.3f} s on {cardname}; "
                  f"launches {launches}", flush=True)
            if d8.shape != frames.shape[:3] or not np.isfinite(d8).all():
                raise AssertionError(f"bad int8 output: shape {d8.shape}")
            calib = not runs   # the first call runs one float forward on window 0
            want = {"spatial_attention": depth if calib else 0,
                    "temporal_attention": 8 * (n_win + calib),
                    "spatial_attention_qk8": depth * n_win}
            if launches != want:
                raise AssertionError(f"int8 launch counts {launches}, expected {want}")
            runs.append((d8, launches))
            del pipe
        if not np.array_equal(runs[0][0], runs[1][0]):
            raise AssertionError("the side file's scales gave other depths than calibration")
        rep = precision_drift_report(runs[0][0], d32)
        print(f"int8 (bf16) vs fp32 on the card: max {rep['max_err_frac']:.5f} / mean "
              f"{rep['mean_err_frac']:.6f} of depth range {rep['depth_range']:.4f} "
              f"(budget {INT8_MAX_ERR_FRAC} / {INT8_MEAN_ERR_FRAC})", flush=True)
        if not (rep["max_err_frac"] < INT8_MAX_ERR_FRAC
                and rep["mean_err_frac"] < INT8_MEAN_ERR_FRAC):
            raise AssertionError(f"int8 drift over budget: {rep}")

        # The reduced clip, fp32 activations, on the card and on the CPU
        # plain path with the card's side file (identical scales), held to
        # the flip floor measured here: the CPU run again with every absmax
        # scaled by 1 + 1e-6 (utils/precision.py::flip_floor_report).
        small = synthetic_video(n=40, hw=(140, 196), seed=5)
        spath = os.path.join(tmp, "small.int8calib.npz")
        g8, _ = VideoDepthPipeline(cfg, model, quant="int8", calib_path=spath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
        cpu_model = copy.deepcopy(model).to("cpu")
        c8, _ = VideoDepthPipeline(cfg, cpu_model, device="cpu", quant="int8", calib_path=spath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
        npath = os.path.join(tmp, "nudged.int8calib.npz")
        scale_side_file(spath, npath, 1 + 1e-6)
        n8, _ = VideoDepthPipeline(cfg, cpu_model, device="cpu", quant="int8", calib_path=npath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
        rep = flip_floor_report(g8, c8, n8)

        def fmt(r):
            return (f"aligned max {r['max_err_frac']:.5f} / mean {r['mean_err_frac']:.6f} of "
                    f"the range, unaligned relative L2 {r['rel_l2']:.3e} / max "
                    f"{r['raw_max_err_frac']:.5f} of the range")
        lim = rep["limit"]
        print(f"card int8 vs CPU plain int8 (fp32, shared side file), 40 frames 140x196 "
              f"(input 112), depth range {rep['got']['depth_range']:.4f}: {fmt(rep['got'])}; "
              f"flip floor (CPU, scales x (1 + 1e-6)): {fmt(rep['floor'])}; limits aligned max "
              f"{lim['max_err_frac']:.5f} / mean {lim['mean_err_frac']:.6f}, relative L2 "
              f"{lim['rel_l2']:.3e}", flush=True)
        if not rep["ok"]:
            raise AssertionError(f"card int8 vs CPU plain int8: {rep}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs[0][1]


def _int8_model(model, x):
    """The int8 model calibrated on x (one window)."""
    from video_depth_anything_torch.ops.quant import quantize_model

    return quantize_model(model, model.calibrate_stats(x))


def timing(cardname):
    """(f): window forward ms/frame at 1x32x518^2, bf16 and int8 (bf16
    activations, calibrated on the timed window); cached steady state."""
    import torch
    from video_depth_anything_torch.config import INFER_LEN, KEYFRAMES, OVERLAP, get_model_config
    from video_depth_anything_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(1)
    for enc in ("vits", "vitl"):
        cfg = get_model_config(enc)
        model = build_model(cfg, seed=0, device="cuda").to(torch.bfloat16)
        x = torch.randn(1, INFER_LEN, 518, 518, 3, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        with torch.no_grad():
            for mode in ("bf16", "int8"):
                m = model if mode == "bf16" else _int8_model(model, x)
                iters = 3 if mode == "int8" and enc == "vitl" else 5
                torch.cuda.reset_peak_memory_stats()
                ms = time_ms(lambda: m(x), iters, 2)
                peak = torch.cuda.max_memory_allocated() / 2**30
                feats = m.encode(x[0])
                enc_ms = time_ms(lambda: m.encode(x[0]), iters, 1)
                head_ms = time_ms(lambda: m.head(feats, 37, 37, 1, INFER_LEN), iters, 1)
                print(f"{enc} window forward 1x32x518x518 {mode}: {ms:.2f} ms/window, "
                      f"{ms / INFER_LEN:.3f} ms/frame (encoder {enc_ms:.2f} ms, head "
                      f"{head_ms:.2f} ms), peak {peak:.2f} GiB on {cardname}", flush=True)
                if enc == "vits":
                    kf = torch.tensor(KEYFRAMES, device="cuda")
                    new = x[0, OVERLAP:]

                    def step():
                        nonlocal feats
                        f = m.encode(new)
                        feats = [(torch.cat([pt[kf], nt]), torch.cat([pc[kf], nc]))
                                 for (pt, pc), (nt, nc) in zip(feats, f)]
                        return m.head(feats, 37, 37, 1, INFER_LEN)

                    ms = time_ms(step, 5, 2)
                    print(f"vits cached steady state 518x518 {mode}: {ms:.2f} ms/window, "
                          f"{ms / (INFER_LEN - OVERLAP):.3f} ms per new frame on {cardname}",
                          flush=True)
                del m, feats
        del model, x
        torch.cuda.empty_cache()


def breakdown(cardname, mode="bf16"):
    """(f) continued: torch.profiler over one vits window forward at
    1x32x518x518 (bf16, or int8 with bf16 activations) — device time by
    kernel, by kind, and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model

    model = build_model(get_model_config("vits"), seed=0, device="cuda").to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, 32, 518, 518, 3, device="cuda", generator=gen, dtype=torch.bfloat16)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        if mode == "int8":
            model = _int8_model(model, x)
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            model(x)
            end.record()
            torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("breakdown: the profiler recorded no device time", flush=True)
        return
    # First match wins: cuDNN's convolutions are named "..._implicit_gemm",
    # and cuBLAS's Hopper GEMMs "nvjet_...".
    kinds = (("K3 spatial_attention_qk8", ("attention_qk8",)),
             ("K1 spatial_attention", ("attention_bf16", "attention_f32")),
             ("K2 temporal_attention", ("temporal_attention",)),
             ("convolution", ("fprop", "conv", "Conv", "winograd", "cudnn")),
             ("GEMM", ("nvjet", "gemm", "Gemm", "cutlass", "cublas")),
             ("copy / concat", ("copy", "Copy", "cat_", "CatArray")),
             ("reduction", ("reduce_kernel", "Reduce")))
    share: dict = {}
    for key, ms, _ in rows:
        kind = next((k for k, pats in kinds if any(p in key for p in pats)), "elementwise")
        share[kind] = share.get(kind, 0.0) + ms
    print(f"breakdown: vits {mode} window forward 1x32x518x518 on {cardname}: wall "
          f"{wall:.2f} ms (profiled), device busy {busy:.2f} ms, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}", flush=True)
    for kind, ms in sorted(share.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:32s} {ms:8.3f} ms  {100 * ms / busy:5.1f} %", flush=True)
    for key, ms, count in rows[:16]:
        print(f"  {ms:8.3f} ms {count:5d}x  {key[:110]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from video_depth_anything_torch.kernels import build  # fails without the repo

    cardname = card()
    print(f"card: {cardname}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN: fp32 phases run in true fp32", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} sources", flush=True)
    for name, log in build.build_log().items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(regs), flush=True)

    errs: dict = {}

    def record(kernel, dtype, err):
        errs[(kernel, dtype)] = max(errs.get((kernel, dtype), 0.0), err)

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = check_k1(gen, record)
    k3 = check_k3(gen, record)
    k2 = check_k2(gen, record)
    torch.cuda.empty_cache()
    launches, d32 = main_path(cardname)
    launches_int8 = int8_path(cardname, d32)
    timing(cardname)
    breakdown(cardname)
    breakdown(cardname, "int8")

    meta = {
        "spatial_attention": dict(
            source="video_depth_anything_torch/csrc/spatial_attention.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:210", main=k1),
        "temporal_attention": dict(
            source="video_depth_anything_torch/csrc/temporal_attention.cu",
            replaces="video_depth_anything_tpu/ops/pallas_temporal_attention.py:72", main=k2),
        "spatial_attention_qk8": dict(
            source="video_depth_anything_torch/csrc/spatial_attention_qk8.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:320", main=k3),
    }
    kernels = []
    for name, m in meta.items():
        e = m["main"]
        # K1 and K2 count the bf16 main path's launches, K3 the first int8
        # call's (it runs on the int8 path only).
        kernels.append({
            "name": name, "route": "cuda", "source": m["source"], "replaces": m["replaces"],
            "launches": (launches_int8 if name == "spatial_attention_qk8" else launches)[name],
            "launches_int8_first_call": launches_int8[name],
            "max_abs_err": max(errs[(name, "bfloat16")], errs[(name, "float32")]),
            "max_abs_err_bf16": errs[(name, "bfloat16")],
            "max_abs_err_fp32": errs[(name, "float32")],
            "tolerance": TOL[name],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "shape": e["shape"], "heads": e["heads"], "dtype": e["dtype"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(cardname, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
