#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (video_depth_anything_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero,
printing no result, without either. Phases, each fatal on failure:

  (a) environment: card name and power limit, torch and CUDA versions;
      TF32 is switched off for matmuls and cuDNN, so fp32 phases are true
      fp32.
  (b) build: nvcc builds every kernel from csrc/ (in parallel); each
      kernel's registers and spills, and the counts of HGMMA (bf16 wgmma),
      IGMMA (int8 wgmma), HMMA (mma.sync), UTMALDG (TMA loads) and SYNCS
      (mbarrier) instructions in each library's SASS (cuobjdump -sass).
      Fails if K1's, K4's, K6's, the option instances' (K1/K4/K5's
      mxu_denom and exp2), T1's, T2's or T3's library lacks HGMMA or
      UTMALDG, K3's IGMMA or UTMALDG, K2's HMMA, if T2's or T3's has HMMA
      (neither runs mma.sync), or if cuobjdump is missing.
  (c) K1 spatial attention against its plain version, bf16 and fp32, at
      the encoders' shapes (strided views of a fused qkv, as the model
      passes them); then the switches: K1 with mxu_denom, exp2 and both,
      K4 and K5 with mxu_denom, each against its plain version with the
      same switches, K1's times (and its plain version's, per switch) at
      the main path's shape beside the default's.
  (c') K3 int8-QK spatial attention against its plain version, bf16 and
      fp32 v, at the same shapes (random int8 q and k, v a column view of
      a fused qkv), and its odd-head fallback (K1 on dequantized q, k).
  (c'') K4 head-major attention against its plain version, bf16 and fp32:
      head-major [32, 16, 1370, 64], split-head views of a vits fused qkv,
      dh = 32 at [32, 12, 1370, 32] and dh = 128 with an odd head count.
  (c''') K5 fused-qkv attention against its plain version at the vits and
      vitl 518^2 shapes, K1's time on the same views beside it; then its
      path (the entry called once per shape) with launch counts.
  (d) K2 temporal attention against its plain version at every motion
      module shape of vits and vitl at 518x518 and of vits at 518x686 (the
      main path's), T = 32 and T = 4; its times (and SDPA's) replayed from
      a CUDA graph, as the smaller shapes take less card time than the
      host needs to launch them.
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
  (e'') a toy encoder with head dim 32 (ViTConfig(128, depth 4, 4 heads),
      taps 0..3, vits's head widths) through VideoDepthPipeline in fp32,
      every spatial attention on K4: launch counts read around the run,
      the output held against the CPU plain path within 1e-3 of the range.
  (e''') the long-video path on (e)'s video, run after (e): infer_video_depth
      with windows_per_batch 2 and 4 (the batched keyframe cache) in bf16
      and fp32, launch counts per call (one encode and one head per chunk),
      fp32 within 1e-4 of the range of (e)'s sequential fp32, bf16 within
      the drift budget of fp32; infer_video_depth_streaming at C = 1 and 4
      equal to the batch API bit for bit; 49 frames at C = 2 (the last
      chunk all resident: no encode), stream equal to batch; the fp16
      transport within 2^-10 of max |d| of the fp32 transport, stream equal
      to batch; int8 at C = 2 (K3's launches, the int8 budget against the
      card's fp32); the window timer's spans; then, through
      tools/bench_long_video.py's modes and measure, the wall ms per frame
      (a second call), peak memory and torch.profiler idle share of
      sequential (overlapped and blocking copies), C = 2, C = 4 and
      streaming (C = 1, 4).
  (h) K6, the fused residual conv unit: the bench tool's function
      (tools/bench_rcu.py) at the four vitl 518^2 RefineNet shapes in bf16
      (error against the plain version, K6 and the two-conv path timed),
      fp32 at two smaller shapes; then the vitl RefineNet cascade at full
      width on the taps of a 1x32x518x518 window, refinenet4 -> 1 with
      motion modules 2 and 3 between, once with use_kernel=True (7 K6
      launches) and once without (none), both timed and compared.
  (i) the bench tools' measurement kernels at their vitl shape (B = 32,
      S = 1370, keys padded to 1408, H = 16, dh = 64), bf16: T1's four
      phase probes (and qk+sm's side sum) and T3's two QK probes against
      their plain versions on the tools' inputs, T2 under each schedule
      against its plain version and against K1; then the tools' functions
      (tools/bench_kernel_phases.py probes and variants,
      tools/bench_kernel_ab.py probes, variants and others) with launch
      counts read around them, each kernel's time beside its bound and
      library time. Dropped products fail it: T1's qk64x2 and qk128 may
      not run faster than their operations bound, and qk64x2 with its sink
      (every key tile's scores stored) may take at most 1.15x its time
      without. T2 stagger must equal K1 mxu_denom=True bit for bit.
  (f) timing: one window forward at 1x32x518x518 in bf16 and in int8,
      vits and vitl, and the cached steady state per new frame for vits;
      then a torch.profiler breakdown of the vits window by kernel kind,
      bf16 and int8.
  (j) the port's bench (video_depth_anything_torch/bench.py) for vits at
      --iters 3 --warmup 1, run last: its record, which may hold no
      section error.
  (g) one JSON line {"kernels": [...]} (nine kernels), then the card's name and power
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
sys.path.insert(0, ROOT)
# The card's peak rates, bound_ms and time_ms are the bench tools' own; this
# import fails, and the script exits non-zero, without the repository.
from video_depth_anything_torch.tools.bench_long_video import (  # noqa: E402
    measure, modes as long_video_modes)
from video_depth_anything_torch.tools.bench_wgmma import graph_ms  # noqa: E402
from video_depth_anything_torch.tools.timing import (  # noqa: E402
    PEAK_OPS, bound_ms, exp_ms, time_ms)

PROBE_MARGIN_S = 0.05                   # marginal card time per tool timing in (i)
# The instructions each library's design rests on: wgmma fed by TMA (bf16
# HGMMA; K3's int8 QK, IGMMA), K2's tensor-core products (HMMA).
SASS_REQUIRED = {"fused_rcu": ("HGMMA", "UTMALDG"),
                 "spatial_attention": ("HGMMA", "UTMALDG"),
                 "attention_head_major": ("HGMMA", "UTMALDG"),
                 "attention_switches": ("HGMMA", "UTMALDG"),
                 "spatial_attention_qk8": ("IGMMA", "UTMALDG"),
                 "temporal_attention": ("HMMA",),
                 "phase_probes": ("HGMMA", "UTMALDG"),
                 "attention_variants": ("HGMMA", "UTMALDG"),
                 "qk_probes": ("HGMMA", "UTMALDG")}
# T2 is the attention body's instance, T3 a wgmma kernel: no mma.sync.
SASS_ABSENT = {"attention_variants": ("HMMA",), "qk_probes": ("HMMA",)}
# Max abs error against the plain version. The spatial kernels' outputs
# are near-uniform averages of unit-normal v over 1370-1814 keys (mean |o|
# about 0.03, max 0.2 to 0.7), so bf16 is held to 4e-3: a few times the
# bf16 rounding seen (1e-3 to 2e-3), below what a dropped key tile or one
# head's mis-scaled softmax gives (5e-2 and up). K2 averages over at most
# 32 frames: outputs of order 1, where a bf16 step is 4e-3 to 1.6e-2.
# K4 and K5 compute K1's function (outputs of the same size). K6's bf16
# output is of order 1 to 5: held to 2^-7 of the reference's max |y| (two
# bf16 steps there; kernel and plain version round the intermediate and
# the output at the same points, and the fp32 order of sums flips a
# rounding now and then).
TOL = {"spatial_attention": {"bfloat16": 4e-3, "float32": 1e-4},
       "spatial_attention_qk8": {"bfloat16": 4e-3, "float32": 1e-4},
       "temporal_attention": {"bfloat16": 2e-2, "float32": 1e-4},
       "attention_head_major": {"bfloat16": 4e-3, "float32": 1e-4},
       "spatial_attention_qkv_fused": {"bfloat16": 4e-3, "float32": 1e-4},
       "fused_rcu": {"bfloat16": "2^-7 max|y|", "float32": 1e-4},
       # T1's bf16 outputs: one bf16 step of the max (kernel and plain
       # version accumulate in fp32 and round once), two for qk+sm (each
       # exponential is rounded too); its side sum and T3's fp32 outputs:
       # 1e-4 of the max (fp32 sums in another order). T2 runs on the tool's
       # N(0, 0.3^2) inputs, where max |o| is about 0.03: 2^-6 of max |o|,
       # two bf16 steps there (K1's 4e-3 would be 16, and would pass a T2
       # that left the padded keys of its last tile in its denominator).
       "phase_probes": {"bfloat16": "2^-7 max|o|; qk+sm x2 2^-6, side sum 1e-4 of the max"},
       "qk_probes": {"bfloat16": "1e-4 max|o|"},
       "attention_variants": {"bfloat16": "2^-6 max|o|"}}


def tolerance(kernel, name, ref):
    tol = TOL[kernel][name]
    return 2 ** -7 * ref.float().abs().max().item() if isinstance(tol, str) else tol


def held(kernel, name, got, ref):
    """(max abs error, whether it holds, and a print of the error beside
    its tolerance and the reference's own size)."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    tol = tolerance(kernel, name, ref)
    ok = err <= tol and bool(torch.isfinite(got).all())
    return err, ok, (f"max_abs_err {err:.3e} (tol {tol:.3g}; reference mean |o| "
                     f"{ref.float().abs().mean().item():.3e}, max |o| "
                     f"{ref.float().abs().max().item():.3e})")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
                      f"bound {bms:.4f} ms ({by}; exponentials alone "
                      f"{exp_ms(b * h * s * s):.4f} ms)", flush=True)
                if not ok:
                    raise AssertionError(f"K1 {name} {label} {layout}: {said}")
                record("spatial_attention", name, err)
                if name == "bfloat16" and label.endswith("cached") and layout == "strided qkv":
                    main = dict(shape=[b, s, c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=bms, bound_by=by)
            del qkv, q, k, v
    return main


def check_switches(gen, record):
    """(c), the switches: K1 with mxu_denom, exp2 and both at the main
    path's and vitl's shapes, K4 (head-major dh 64 and 32) and K5 (vits)
    with mxu_denom, bf16 and fp32, each against its plain version with the
    same switches; returns K1's times at the main path's shape in bf16."""
    import torch
    from video_depth_anything_torch.kernels import attention_head_major as k4
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qkv as k5

    times = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, b, s, h in (("vits 518x686 cached", 22, 1814, 6), ("vitl 518^2", 32, 1370, 16)):
            c = h * 64
            qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            for sw in (dict(), dict(mxu_denom=True), dict(exp2=True),
                       dict(mxu_denom=True, exp2=True)):
                def run(sw=sw):
                    return k1.spatial_attention(q, k, v, num_heads=h, scale=0.125, **sw)

                line = f"K1 {name:8s} {label:20s} {'+'.join(sw) or 'default':15s}"
                if sw:
                    got = run()
                    ref = k1.spatial_attention_plain(q, k, v, num_heads=h, scale=0.125, **sw)
                    torch.cuda.synchronize()
                    err, ok, said = held("spatial_attention", name, got, ref)
                    line += f" {said}"
                    if not ok:
                        raise AssertionError(f"{line}")
                    record("spatial_attention", name, err)
                if name == "bfloat16" and label.endswith("cached"):
                    times["+".join(sw) or "default"] = ms = time_ms(run, 20)
                    plain = time_ms(lambda sw=sw: k1.spatial_attention_plain(
                        q, k, v, num_heads=h, scale=0.125, **sw), 3, 1)
                    times["plain " + ("+".join(sw) or "default")] = plain
                    line += f" kernel {ms:.4f} ms, plain {plain:.3f} ms"
                print(line, flush=True)
            del qkv, q, k, v
        for label, b, h, s, d in (("head-major", 32, 16, 1370, 64),
                                  ("head-major dh 32", 32, 12, 1370, 32)):
            q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            got = k4.attention_head_major(q, k, v, scale=d ** -0.5, mxu_denom=True)
            ref = k4.attention_head_major_plain(q, k, v, scale=d ** -0.5, mxu_denom=True)
            torch.cuda.synchronize()
            err, ok, said = held("attention_head_major", name, got, ref)
            print(f"K4 {name:8s} {label:20s} mxu_denom [{b},{h},{s},{d}]: {said}", flush=True)
            if not ok:
                raise AssertionError(f"K4 {name} {label} mxu_denom: {said}")
            record("attention_head_major", name, err)
            del q, k, v
        qkv = torch.randn(32, 1370, 3 * 384, device="cuda", generator=gen).to(dt)
        qkv[..., :384] *= 0.125
        got = k5.spatial_attention_qkv_fused(qkv, num_heads=6, mxu_denom=True)
        ref = k5.spatial_attention_qkv_fused_plain(qkv, num_heads=6, mxu_denom=True)
        torch.cuda.synchronize()
        err, ok, said = held("spatial_attention_qkv_fused", name, got, ref)
        print(f"K5 {name:8s} vits 518^2 mxu_denom [32,1370,1152]: {said}", flush=True)
        if not ok:
            raise AssertionError(f"K5 {name} mxu_denom: {said}")
        record("spatial_attention_qkv_fused", name, err)
        del qkv
    torch.cuda.empty_cache()
    return times


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
            # int8 QK and float PV at their own peaks, one after the other.
            bms, by = bound_ms(ops * (1 + PEAK_OPS[name] / PEAK_OPS["int8"]),
                               b * s * c * (2 + 2 * v.element_size()), name)
            print(f"K3 {name:8s} {label:20s} [{b},{s},{c}] H={h}: {said} kernel {ms:.3f} ms, "
                  f"plain {plain:.3f} ms, sdpa {lib:.3f} ms, bound {bms:.4f} ms ({by}; "
                  f"exponentials alone {exp_ms(b * h * s * s):.4f} ms)", flush=True)
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
                        # Replayed from a CUDA graph: the smaller shapes take
                        # less card time than the host needs to launch them.
                        ms = graph_ms(lambda: k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5), 20)
                        plain = time_ms(lambda: k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5), 5, 1)
                        heads = [x.unflatten(-1, (8, dh)).transpose(1, 2) for x in (q, k, v)]
                        lib = graph_ms(lambda: F.scaled_dot_product_attention(*heads, scale=dh ** -0.5), 20)
                        bms, by = bound_ms(4 * p * t * t * c, 4 * p * t * c * q.element_size(), name)
                        line += (f" kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                                 f"bound {bms:.4f} ms ({by}; exponentials alone "
                                 f"{exp_ms(p * 8 * t * t):.4f} ms)")
                        if name == "bfloat16" and enc == "vits 518x686" and mod == 3:
                            main = dict(shape=[p, t, c], heads=8, dtype=name, ms=ms,
                                        plain_ms=plain, library_ms=lib, bound_ms=bms,
                                        bound_by=by)
                    print(line, flush=True)
                    if not ok:
                        raise AssertionError(f"K2 {name} {enc} module {mod} T={t}: {said}")
                    record("temporal_attention", name, err)
    return main


def check_k4(gen, record):
    """(c''): K4 at head-major and split-head shapes; returns the entry of
    [32, 16, 1370, 64] bf16."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch.kernels import attention_head_major as k4

    main = None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, b, h, s, d in (("head-major", 32, 16, 1370, 64),
                                  ("vits qkv split views", 32, 6, 1370, 64),
                                  ("head-major dh 32", 32, 12, 1370, 32),
                                  ("head-major dh 128 odd H", 16, 5, 1370, 128)):
            if label.startswith("vits"):
                qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen).to(dt)
                q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)).transpose(1, 2)
                           for i in range(3))
            else:
                q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)
                           for _ in range(3))
            scale = d ** -0.5
            got = k4.attention_head_major(q, k, v, scale=scale)
            ref = k4.attention_head_major_plain(q, k, v, scale=scale)
            torch.cuda.synchronize()
            err, ok, said = held("attention_head_major", name, got, ref)
            iters = 5 if name == "float32" else 20
            ms = time_ms(lambda: k4.attention_head_major(q, k, v, scale=scale), iters)
            plain = time_ms(lambda: k4.attention_head_major_plain(q, k, v, scale=scale), 3, 1)
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
            bms, by = bound_ms(4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(), name)
            print(f"K4 {name:8s} {label:24s} [{b},{h},{s},{d}]: {said} kernel {ms:.3f} ms, "
                  f"plain {plain:.3f} ms, sdpa {lib:.3f} ms, bound {bms:.4f} ms ({by}; "
                  f"exponentials alone {exp_ms(b * h * s * s):.4f} ms)", flush=True)
            if not ok:
                raise AssertionError(f"K4 {name} {label}: {said}")
            record("attention_head_major", name, err)
            if name == "bfloat16" and label == "head-major":
                main = dict(shape=[b, h, s, d], heads=h, dtype=name, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bms, bound_by=by)
            del q, k, v, got, ref
            torch.cuda.empty_cache()
    return main


def check_k5(gen, record):
    """(c'''): K5 at the vits and vitl 518^2 shapes, then its path (the
    entry called once per shape, launches counted); returns the entry of
    the vits shape in bf16 and the path's launch counts."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qkv as k5

    shapes = [("vits 518^2", 32, 1370, 6), ("vitl 518^2", 32, 1370, 16)]
    main, inputs = None, []
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, b, s, h in shapes:
            c = h * 64
            qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
            qkv[..., :c] *= 0.125   # q pre-scaled, as the entry takes it
            got = k5.spatial_attention_qkv_fused(qkv, num_heads=h)
            ref = k5.spatial_attention_qkv_fused_plain(qkv, num_heads=h)
            torch.cuda.synchronize()
            err, ok, said = held("spatial_attention_qkv_fused", name, got, ref)
            iters = 5 if name == "float32" else 20
            ms = time_ms(lambda: k5.spatial_attention_qkv_fused(qkv, num_heads=h), iters)
            plain = time_ms(lambda: k5.spatial_attention_qkv_fused_plain(qkv, num_heads=h), 3, 1)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            k1_ms = time_ms(lambda: k1.spatial_attention(q, k, v, num_heads=h, scale=1.0), iters)
            heads = [t.unflatten(-1, (h, 64)).transpose(1, 2) for t in (q, k, v)]
            lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), iters)
            bms, by = bound_ms(4 * b * h * s * s * 64, 4 * b * s * c * qkv.element_size(), name)
            print(f"K5 {name:8s} {label:12s} [{b},{s},{3 * c}] H={h}: {said} kernel {ms:.3f} ms, "
                  f"K1 on the same views {k1_ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms, "
                  f"bound {bms:.4f} ms ({by}; exponentials alone {exp_ms(b * h * s * s):.4f} ms)",
                  flush=True)
            if not ok:
                raise AssertionError(f"K5 {name} {label}: {said}")
            record("spatial_attention_qkv_fused", name, err)
            if name == "bfloat16":
                inputs.append((qkv, h))
                if label.startswith("vits"):
                    main = dict(shape=[b, s, 3 * c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=bms, bound_by=by, k1_ms=k1_ms)
            del got, ref, heads
    kernels.reset_launch_counts()
    for qkv, h in inputs:
        k5.spatial_attention_qkv_fused(qkv, num_heads=h)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"K5 path: the fused-qkv entry at the vits and vitl shapes, bf16; launches {launches}",
          flush=True)
    want = {name: 0 for name in launches}
    want["spatial_attention_qkv_fused"] = len(inputs)
    if launches != want:
        raise AssertionError(f"K5 path launch counts {launches}, expected {want}")
    del inputs
    torch.cuda.empty_cache()
    return main, launches


def check_k6(gen, record):
    """(h), first part: the bench tool at the four vitl shapes in bf16,
    fp32 at two smaller shapes; returns the entry of (32, 148, 148, 256)."""
    import torch
    from video_depth_anything_torch.kernels import fused_rcu as k6
    from video_depth_anything_torch.tools import bench_rcu

    rows = bench_rcu.bench(iters=10)
    for row in rows:
        tol = 2 ** -7 * row["ref_max_abs"]
        if not row["max_abs_err"] <= tol:
            raise AssertionError(f"K6 bfloat16 {row['shape']}: max_abs_err "
                                 f"{row['max_abs_err']:.3e} over {tol:.3e}")
        record("fused_rcu", "bfloat16", row["max_abs_err"])
    big = rows[0]
    with torch.no_grad():
        # The plain version's time at the main shape (fp32 convolutions).
        rcu = bench_rcu.random_unit(big["shape"][3], gen)
        x = torch.randn(big["shape"], device="cuda", generator=gen).to(torch.bfloat16)
        plain = time_ms(lambda: k6.fused_rcu_plain(x, *rcu.kernel_operands(x.dtype)), 3, 1)
        main = dict(shape=big["shape"], dtype="bfloat16", ms=big["kernel_ms"], plain_ms=plain,
                    library_ms=big["chain_ms"], bound_ms=big["bound_ms"],
                    bound_by=big["bound_by"])
        del rcu, x
        for shape in ((2, 37, 37, 256), (4, 19, 19, 128)):
            rcu = bench_rcu.random_unit(shape[3], gen, torch.float32)
            x = torch.randn(shape, device="cuda", generator=gen)
            got = rcu(x, use_kernel=True)
            ref = k6.fused_rcu_plain(x, *rcu.kernel_operands(x.dtype))
            torch.cuda.synchronize()
            err, ok, said = held("fused_rcu", "float32", got, ref)
            ms = time_ms(lambda: rcu(x, use_kernel=True), 5)
            chain = time_ms(lambda: rcu(x), 5)
            bms, by = bound_ms(bench_rcu.flops(shape), 2 * x.numel() * 4, "float32")
            print(f"K6 float32 {tuple(shape)}: {said} kernel {ms:.3f} ms, two-conv path "
                  f"{chain:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)
            if not ok:
                raise AssertionError(f"K6 float32 {shape}: {said}")
            record("fused_rcu", "float32", err)
    return main


def check_probes(record):
    """(i), first part: T1, T3 and T2 at the bench tools' vitl shape in bf16
    against their plain versions on the tools' own inputs (T2 also against
    K1); returns the inputs and each kernel's plain time."""
    import torch
    from video_depth_anything_torch.kernels import attention_variants as t2
    from video_depth_anything_torch.kernels import qk_probes as qp
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.tools import bench_kernel_phases as phases

    def fail_over(label, err, tol, ref):
        print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}; reference max |o| "
              f"{ref.float().abs().max().item():.3e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{label}: max_abs_err {err:.3e} over {tol:.3e}")

    def err_of(got, ref):
        if got.dtype != ref.dtype or got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"dtype {got.dtype} / {ref.dtype}, shape {tuple(got.shape)} / "
                                 f"{tuple(ref.shape)}, or not finite")
        return (got.float() - ref.float()).abs().max().item()

    probe_in = phases.probe_inputs()
    q, k = probe_in["qk"]
    plain = {}
    t1_plain = {"qk64x2": lambda: qp.qk_first128_plain(q, k, heads=2),
                "qk128": lambda: qp.qk_first128_plain(q, k, heads=1),
                "qk+sm x2": lambda: qp.qk_softmax_plain(q, k),
                "pv128x2": lambda: qp.pv_plain(*probe_in["pv"])}
    for name, ref_fn in t1_plain.items():
        args = probe_in["pv"] if name == "pv128x2" else (q, k)
        if name == "qk+sm x2":
            got, side = qp.phase_probe(name, *args, side=True)
            ref, ref_side = ref_fn()
            err = err_of(got, ref)
            side_err = err_of(side, ref_side)
            fail_over(f"T1 {name} side sum [64, 1408] fp32", side_err,
                      1e-4 * ref_side.abs().max().item(), ref_side)
            tol = 2 ** -6 * ref.float().abs().max().item()
        else:
            got, ref = qp.phase_probe(name, *args), ref_fn()
            err = err_of(got, ref)
            tol = 2 ** -7 * ref.float().abs().max().item()
        torch.cuda.synchronize()
        fail_over(f"T1 {name} {list(got.shape)} bf16", err, tol, ref)
        record("phase_probes", "bfloat16", err)
        plain["T1 " + name] = time_ms(ref_fn, 2, 1)
        del got, ref
    for name, heads in (("qk64 x2heads", 2), ("qk128 x1", 1)):
        got = qp.qk_probe(q, k, heads=heads)
        ref = qp.qk_colsum_plain(q, k, heads=heads)
        torch.cuda.synchronize()
        err = err_of(got, ref)
        fail_over(f"T3 {name} {list(got.shape)} fp32 out", err,
                  1e-4 * ref.abs().max().item(), ref)
        record("qk_probes", "bfloat16", err)
        plain["T3 " + name] = time_ms(lambda h=heads: qp.qk_colsum_plain(q, k, heads=h), 2, 1)
        del got, ref
    var_in = phases.variant_inputs()
    h = phases.H
    ref = t2.attention_variant_plain(*var_in, num_heads=h)
    k1_out = k1.spatial_attention(*var_in, num_heads=h, scale=phases.DH ** -0.5)
    k1_mxu = k1.spatial_attention(*var_in, num_heads=h, scale=phases.DH ** -0.5, mxu_denom=True)
    for sched in t2.SCHEDULES:
        got = t2.attention_variant(*var_in, num_heads=h, schedule=sched)
        torch.cuda.synchronize()
        err = err_of(got, ref)
        fail_over(f"T2 {sched} {list(got.shape)} H={h} bf16 against its plain version", err,
                  2 ** -6 * ref.float().abs().max().item(), ref)
        fail_over(f"T2 {sched} against K1 on the same inputs", err_of(got, k1_out),
                  2 ** -6 * k1_out.float().abs().max().item(), k1_out)
        record("attention_variants", "bfloat16", err)
        if sched == "stagger":   # the body's instance that K1 runs with mxu_denom=True
            same = torch.equal(got, k1_mxu)
            print(f"T2 stagger equals K1 mxu_denom=True bit for bit: {same}", flush=True)
            if not same:
                raise AssertionError("T2 stagger differs from K1 mxu_denom=True")
    plain["T2"] = time_ms(lambda: t2.attention_variant_plain(*var_in, num_heads=h), 2, 1)
    del ref, k1_out, k1_mxu, got
    torch.cuda.empty_cache()
    print("plain versions, ms: " + ", ".join(f"{n} {t:.3f}" for n, t in plain.items()),
          flush=True)
    return dict(probes=probe_in, variants=var_in), plain


def probe_path(cardname, inputs, plain):
    """(i), second part: the two bench tools' functions at their vitl shape
    (the path of T1-T3), launch counts read around them; returns the
    kernels' entries and the counts."""
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.tools import bench_kernel_ab as ab
    from video_depth_anything_torch.tools import bench_kernel_phases as phases

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = phases.probes(PROBE_MARGIN_S, inputs=inputs["probes"])
    t2 = phases.variants(PROBE_MARGIN_S, inputs=inputs["variants"])
    t3 = ab.probes(PROBE_MARGIN_S, inputs=inputs["probes"])
    ab_prod = ab.variants(PROBE_MARGIN_S, inputs=inputs["variants"])
    others = ab.others(PROBE_MARGIN_S)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"bench tools at B={phases.B} S={phases.S} ({phases.S_PAD}) H={phases.H} "
          f"dh={phases.DH} bf16 on {cardname}, times warm in L2, "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    if not all(launches[n] > 0 for n in ("phase_probes", "attention_variants", "qk_probes")):
        raise AssertionError(f"a measurement kernel was not launched on the tools' path: "
                             f"{launches}")
    # Dropped products: a QK probe faster than its operations bound, or
    # qk64x2 much faster without its sink (the sink reads every key tile's
    # scores) than with it.
    for name in ("qk64x2", "qk128"):
        r = t1[name]
        print(f"T1 {name} {r['ms']:.4f} ms against its operations bound {r['ops_ms']:.4f} ms",
              flush=True)
        if r["ms"] < r["ops_ms"]:
            raise AssertionError(f"T1 {name} runs under its operations bound: products dropped")
    sink = t1["derived"]["sink_over_plain"]
    print(f"T1 qk64x2 with its sink / without: {sink:.3f} (at most 1.15)", flush=True)
    if not sink <= 1.15:
        raise AssertionError(f"T1 qk64x2 with its sink takes {sink:.3f}x its time without: "
                             f"products were dropped")
    qk_main, t3_main, t2_main = t1["qk64x2"], t3["qk64 x2heads"], t2["base"]
    entries = {
        "phase_probes": dict(
            shape=[phases.QK_STEPS, phases.S_PAD, 128], dtype="bfloat16", ms=qk_main["ms"],
            plain_ms=plain["T1 qk64x2"], bound_ms=qk_main["bound_ms"],
            bound_by=qk_main["bound_by"], library_ms=None,
            library="none: no one PyTorch call computes the narrowed output",
            probes={n: dict(ms=r["ms"], us_per_step=r["us_per_step"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], plain_ms=plain["T1 " + n.split(" sink")[0]])
                    for n, r in t1.items() if n != "derived"},
            derived=t1["derived"]),
        "attention_variants": dict(
            shape=[phases.B, phases.S, phases.H * phases.DH], heads=phases.H, dtype="bfloat16",
            ms=t2_main["ms"], plain_ms=plain["T2"], bound_ms=t2_main["bound_ms"],
            bound_by=t2_main["bound_by"], library_ms=t2["sdpa"]["ms"],
            schedules={n: dict(ms=t2[n]["ms"], err_vs_k1=t2[n]["err_vs_k1"],
                               err_vs_k1_mxu_denom=t2[n]["err_vs_k1_mxu_denom"])
                       for n in ("base", "stagger", "kchunk")},
            k1_ms=t2["prod"]["ms"], k1_mxu_denom_ms=t2["prod mxu_denom"]["ms"]),
        "qk_probes": dict(
            shape=[phases.QK_STEPS, phases.S_PAD, 128], dtype="bfloat16", ms=t3_main["ms"],
            plain_ms=plain["T3 qk64 x2heads"], bound_ms=t3_main["bound_ms"],
            bound_by=t3_main["bound_by"], library_ms=None,
            library="none: no one PyTorch call computes the column-group sums",
            probes={n: dict(ms=t3[n]["ms"], bound_ms=t3[n]["bound_ms"],
                            plain_ms=plain["T3 " + n]) for n in ("qk64 x2heads", "qk128 x1")},
            ratio=t3["ratio"]),
    }
    print(f"tool rows, ms: K1 prod {ab_prod['prod']['ms']:.3f}, mxu_denom "
          f"{ab_prod['prod mxu_denom']['ms']:.3f}, exp2 {ab_prod['exp2']['ms']:.3f} "
          f"(sdpa {ab_prod['sdpa']['ms']:.3f}), "
          + ", ".join(f"{n} {r['ms']:.3f} (sdpa {r['sdpa_ms']:.3f})" for n, r in others.items()),
          flush=True)
    del inputs
    torch.cuda.empty_cache()
    return entries, launches


def rcu_cascade(cardname):
    """(h), second part: the vitl RefineNet cascade at full width on the
    taps of one 1x32x518x518 window, with and without K6; returns the
    launch counts of the use_kernel=True run."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import INFER_LEN, get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.utils.precision import MAX_ERR_FRAC, MEAN_ERR_FRAC

    model = build_model(get_model_config("vitl"), seed=0, device="cuda").to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(INFER_LEN, 518, 518, 3, device="cuda", generator=gen, dtype=torch.bfloat16)
    head, sc = model.head, model.head.scratch
    with torch.no_grad():
        l1, l2, l3, l4 = head.refine_inputs(model.encode(x), 37, 37, 1, INFER_LEN)
        del x

        def cascade(use_kernel):   # DPTHeadTemporal.forward's refinenet4 -> 1
            p4 = head.tmod(2, sc.refinenet4(l4, size=l3.shape[1:3], use_kernel=use_kernel),
                           1, INFER_LEN)
            p3 = head.tmod(3, sc.refinenet3(p4, l3, size=l2.shape[1:3], use_kernel=use_kernel),
                           1, INFER_LEN)
            p2 = sc.refinenet2(p3, l2, size=l1.shape[1:3], use_kernel=use_kernel)
            return sc.refinenet1(p2, l1, use_kernel=use_kernel)

        runs = {}
        for use_kernel in (True, False):
            kernels.reset_launch_counts()
            out = cascade(use_kernel)
            torch.cuda.synchronize()
            runs[use_kernel] = (out.float(), kernels.launch_counts())
        ms_k = time_ms(lambda: cascade(True), 5)
        ms_d = time_ms(lambda: cascade(False), 5)
    (got, launches), (ref, plain_launches) = runs[True], runs[False]
    rng = (ref.max() - ref.min()).item()
    d = (got - ref).abs()
    max_frac, mean_frac = d.max().item() / rng, d.mean().item() / rng
    rel_l2 = (torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)).item()
    print(f"vitl RefineNet cascade bf16, 1x32x518x518 taps -> path_1 {tuple(got.shape)} on "
          f"{cardname}: use_kernel=True {ms_k:.2f} ms, launches {launches}; two-conv path "
          f"{ms_d:.2f} ms, launches {plain_launches}; difference max {max_frac:.5f} / mean "
          f"{mean_frac:.6f} of the range {rng:.4f} (bf16 budget {MAX_ERR_FRAC} / "
          f"{MEAN_ERR_FRAC}), relative L2 {rel_l2:.3e}", flush=True)
    if launches["fused_rcu"] != 7 or plain_launches["fused_rcu"] != 0:
        raise AssertionError(f"cascade K6 launches {launches['fused_rcu']} (want 7) and "
                             f"{plain_launches['fused_rcu']} (want 0)")
    if not (np.isfinite(max_frac) and max_frac < MAX_ERR_FRAC and mean_frac < MEAN_ERR_FRAC):
        raise AssertionError(f"cascade with K6 off the two-conv path: {max_frac}, {mean_frac}")
    del model, runs, got, ref, l1, l2, l3, l4
    torch.cuda.empty_cache()
    return launches


def head_major_path(cardname):
    """(e''): a head-dim-32 encoder through the pipeline, fp32, on the card;
    returns the launch counts of the run."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import ViTConfig, get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.utils.precision import synthetic_video

    cfg = get_model_config("vits", taps=(0, 1, 2, 3),
                           vit_override=ViTConfig(embed_dim=128, depth=4, num_heads=4))
    model = build_model(cfg, seed=0, device="cuda")
    frames = synthetic_video(n=40, hw=(140, 196), seed=5)
    n_win = num_windows(len(frames))
    kernels.reset_launch_counts()
    got, _ = VideoDepthPipeline(cfg, model).infer_video_depth(frames, input_size=112, fp32=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ref, _ = VideoDepthPipeline(cfg, copy.deepcopy(model).to("cpu"), device="cpu"
                                ).infer_video_depth(frames, input_size=112, fp32=True)
    rng = float(ref.max() - ref.min())
    err = float(np.abs(got - ref).max()) / max(rng, 1e-12)
    print(f"head dim 32 path: ViT 128 / depth 4 / 4 heads, {len(frames)} frames 140x196 (input "
          f"112), {n_win} windows, fp32 on {cardname}: launches {launches}; card vs CPU plain "
          f"path max {err:.3e} of depth range {rng:.4f} (tol 1e-3)", flush=True)
    want = {name: 0 for name in launches}
    want.update(attention_head_major=cfg.vit.depth * n_win, temporal_attention=8 * n_win)
    if launches != want:
        raise AssertionError(f"head dim 32 launch counts {launches}, expected {want}")
    if got.shape != frames.shape[:3] or not err < 1e-3:
        raise AssertionError(f"head dim 32 path: shape {got.shape}, error {err}")
    return launches


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
    want = {name: 0 for name in launches}                 # K3 int8 only, K4-K6 off
    want.update(spatial_attention=cfg.vit.depth * n_win,   # 12 per encode
                temporal_attention=8 * n_win)               # 4 modules x 2 blocks
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
            want = {name: 0 for name in launches}
            want.update(spatial_attention=depth if calib else 0,
                        temporal_attention=8 * (n_win + calib),
                        spatial_attention_qk8=depth * n_win)
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


def long_video_path(cardname, d32):
    """(e'''): the long-video path, vits at full width, on the card: the
    batched keyframe cache at C = 2 and 4 (bf16 and fp32, launch counts per
    call), streaming against the batch API bit for bit (C = 1, 4; n = 49 at
    C = 2, whose last chunk encodes nothing), the fp16 transport, int8 at
    C = 2, the window timer, then wall ms per frame, peak memory and the
    idle share per mode. Returns (the launches of the bf16 C = 2 call, of
    the int8 C = 2 call, the timings)."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.utils.precision import (
        INT8_MAX_ERR_FRAC, INT8_MEAN_ERR_FRAC, MAX_ERR_FRAC, MEAN_ERR_FRAC,
        precision_drift_report, synthetic_video)

    cfg = get_model_config("vits")
    depth = cfg.vit.depth
    model = build_model(cfg, seed=0, device="cuda")
    pipe = VideoDepthPipeline(cfg, model)
    frames = synthetic_video(n=100, hw=(480, 640), seed=3)     # (e)'s video, 5 windows
    steps = {1: 5, 2: 3, 4: 2}                                 # chunks of C windows
    rng32 = float(d32.max() - d32.min())

    def counted(p, fr, **kw):
        kernels.reset_launch_counts()
        out, _ = p.infer_video_depth(fr, **kw)
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    def want(**launched):
        return {name: launched.get(name, 0) for name in kernels.KERNELS}

    def stream(p, fr, **kw):
        return np.concatenate(list(p.infer_video_depth_streaming(iter(fr), **kw)))

    batch, launches = {}, {}
    for c in (2, 4):
        for fp32 in (False, True):
            out, got = counted(pipe, frames, windows_per_batch=c, fp32=fp32)
            expect = want(spatial_attention=depth * steps[c], temporal_attention=8 * steps[c])
            name = "fp32" if fp32 else "bf16"
            line = f"long video: C = {c} {name}, 100 frames 480x640: launches {got}"
            if got != expect or out.shape != frames.shape[:3] or not np.isfinite(out).all():
                raise AssertionError(f"{line}; expected {expect}")
            if fp32:
                err = float(np.abs(out - d32).max()) / rng32
                line += f"; against (e)'s sequential fp32 max {err:.3e} of the range (tol 1e-4)"
                if not err <= 1e-4:
                    raise AssertionError(line)
            else:
                launches[c] = got
            batch[c, name] = out
            print(line, flush=True)
        rep = precision_drift_report(batch[c, "bf16"], batch[c, "fp32"])
        print(f"long video: C = {c} bf16 vs fp32: max {rep['max_err_frac']:.5f} / mean "
              f"{rep['mean_err_frac']:.6f} (budget {MAX_ERR_FRAC} / {MEAN_ERR_FRAC})", flush=True)
        if not (rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC):
            raise AssertionError(f"C = {c} bf16 drift over budget: {rep}")

    batch[1, "bf16"], _ = pipe.infer_video_depth(frames)
    for c in (1, 4):
        same = np.array_equal(stream(pipe, frames, windows_per_batch=c), batch[c, "bf16"])
        print(f"long video: streaming C = {c} equals the batch API bit for bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"streaming C = {c} differs from the batch API")

    short = frames[:49]
    out, got = counted(pipe, short, windows_per_batch=2)
    same = np.array_equal(stream(pipe, short, windows_per_batch=2), out)
    print(f"long video: n = 49, C = 2 (the last chunk all resident): launches {got}; stream "
          f"equals batch bit for bit: {same}", flush=True)
    if got != want(spatial_attention=depth, temporal_attention=16) or not same:
        raise AssertionError("n = 49, C = 2: a zero-size encode ran, or stream != batch")

    p16 = VideoDepthPipeline(cfg, model, transfer_fp16=True)
    h16, _ = p16.infer_video_depth(frames, windows_per_batch=2)
    ref = batch[2, "bf16"]
    err, tol = float(np.abs(h16 - ref).max()), 2.0 ** -10 * float(np.abs(ref).max())
    same = np.array_equal(stream(p16, frames, windows_per_batch=2), h16)
    print(f"long video: transfer_fp16 C = 2: max {err:.3e} from the fp32 transport (tol "
          f"{tol:.3e}); stream equals batch bit for bit: {same}", flush=True)
    if not (err <= tol and same and h16.dtype == np.float32):
        raise AssertionError("transfer_fp16 off the fp32 transport, or stream != batch")
    del p16

    p8 = VideoDepthPipeline(cfg, model, quant="int8")     # calibrates: one float window
    d8, got8 = counted(p8, frames, windows_per_batch=2)
    rep = precision_drift_report(d8, batch[2, "fp32"])
    print(f"long video: int8 C = 2: launches {got8}; against the card's fp32 C = 2 max "
          f"{rep['max_err_frac']:.5f} / mean {rep['mean_err_frac']:.6f} (budget "
          f"{INT8_MAX_ERR_FRAC} / {INT8_MEAN_ERR_FRAC})", flush=True)
    if got8 != want(spatial_attention=depth, temporal_attention=8 * (steps[2] + 1),
                    spatial_attention_qk8=depth * steps[2]):
        raise AssertionError(f"int8 C = 2 launch counts {got8}")
    if not (rep["max_err_frac"] < INT8_MAX_ERR_FRAC and rep["mean_err_frac"] < INT8_MEAN_ERR_FRAC):
        raise AssertionError(f"int8 C = 2 drift over budget: {rep}")
    del p8

    pipe.infer_video_depth(frames, windows_per_batch=2, collect_timings=True)
    spans = pipe.timer.summary()
    print(f"long video: C = 2 window timer: {json.dumps(spans)}", flush=True)
    if set(spans) != {"window_forward", "gather_upload"} or spans["window_forward"]["count"] != 3:
        raise AssertionError(f"window timer spans {spans}")

    timings = {name: measure(call, len(frames), repeats=1)
               for name, call in long_video_modes(pipe, frames).items()}
    for name, t in timings.items():
        print(f"long video timing on {cardname}, vits bf16, 100 frames 480x640 -> 518x686, "
              f"{name}: {t['ms_per_frame']:.3f} ms/frame (wall, second call), peak "
              f"{t['peak_gib']:.2f} GiB; profiled wall {t['profiled_wall_ms']:.1f} ms, kernels "
              f"busy {t['kernel_busy_ms']:.1f} ms, copies {t['copy_ms']:.1f} ms, idle share "
              f"{t['idle_share']:.3f}", flush=True)
    del pipe, model, batch
    torch.cuda.empty_cache()
    return launches[2], got8, timings


def bench_phase():
    """(j): the port's bench for vits at --iters 3 --warmup 1 (its main, in
    this process); its record is printed, and a section error fails."""
    import contextlib
    import io

    from video_depth_anything_torch import bench

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--encoder", "vits", "--iters", "3", "--warmup", "1"])
    record = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"bench (j), {time.perf_counter() - t0:.1f} s, rc {rc}: record {json.dumps(record)}",
          flush=True)
    errors = [k for k in record if k.endswith("_error")]
    if rc != 0 or errors or record.get("value") is None:
        raise AssertionError(f"bench: rc {rc}, errors {errors}")
    return record


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
    # K3 in bf16 is the flash body's int8-QK instance, attention_bf16<64, true, ...>.
    kinds = (("K3 spatial_attention_qk8", ("attention_qk8", "attention_bf16<64, true")),
             ("K1 spatial_attention", ("attention_bf16", "attention_f32")),
             ("K2 temporal_attention", ("temporal_attention", "temporal_bf16", "temporal_f32")),
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
          f"{1 - busy / wall:.3f}", flush=True)
    for kind, ms in sorted(share.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:32s} {ms:8.3f} ms  {100 * ms / busy:5.1f} %", flush=True)
    for key, ms, count in rows[:16]:
        print(f"  {ms:8.3f} ms {count:5d}x  {key[:110]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from video_depth_anything_torch.kernels import build

    cardname = card()
    print(f"card: {cardname}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN: fp32 phases run in true fp32", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} sources", flush=True)
    sass = {name: build.sass_counts(name) for name in build.SOURCES}
    for name, log in build.build_log().items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "wgmma" in ln or "setmaxnreg" in ln]
        print(f"  {name}: " + " | ".join(regs), flush=True)
    print("SASS (cuobjdump): " + "; ".join(
        f"{name} " + " ".join(f"{op} {n}" for op, n in sass[name].items())
        for name in build.SOURCES), flush=True)
    for name, ops in SASS_REQUIRED.items():
        missing = [op for op in ops if sass[name][op] == 0]
        if missing:
            raise AssertionError(f"{name}: no {', '.join(missing)} in its SASS; the design "
                                 f"runs on them")
    for name, ops in SASS_ABSENT.items():
        present = [op for op in ops if sass[name][op] > 0]
        if present:
            raise AssertionError(f"{name}: {', '.join(present)} in its SASS; the design has none")

    errs: dict = {}

    def record(kernel, dtype, err):
        errs[(kernel, dtype)] = max(errs.get((kernel, dtype), 0.0), err)

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = check_k1(gen, record)
    k1["switches_ms"] = check_switches(gen, record)
    k3 = check_k3(gen, record)
    k4 = check_k4(gen, record)
    k5, launches_k5 = check_k5(gen, record)
    k2 = check_k2(gen, record)
    k6 = check_k6(gen, record)
    torch.cuda.empty_cache()
    probe_inputs, probe_plain = check_probes(record)
    probe_entries, launches_tools = probe_path(cardname, probe_inputs, probe_plain)
    del probe_inputs
    launches, d32 = main_path(cardname)
    launches_long, launches_long_int8, long_timings = long_video_path(cardname, d32)
    launches_int8 = int8_path(cardname, d32)
    launches_k4 = head_major_path(cardname)
    launches_k6 = rcu_cascade(cardname)
    timing(cardname)
    breakdown(cardname)
    breakdown(cardname, "int8")
    bench_record = bench_phase()

    # Each kernel's launches are counted on its own path: K1 and K2 on the
    # bf16 main path, K3 on the first int8 call, K4 on the head-dim-32
    # pipeline, K5 on its entry's own run, K6 on the vitl RefineNet cascade,
    # T1-T3 on the bench tools' run. T1-T3 are bf16 only (no fp32 error).
    bf16_only = ("phase_probes", "attention_variants", "qk_probes")
    meta = {
        "spatial_attention": dict(
            source="video_depth_anything_torch/csrc/spatial_attention.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:210", main=k1,
            path=launches),
        "temporal_attention": dict(
            source="video_depth_anything_torch/csrc/temporal_attention.cu",
            replaces="video_depth_anything_tpu/ops/pallas_temporal_attention.py:72", main=k2,
            path=launches),
        "spatial_attention_qk8": dict(
            source="video_depth_anything_torch/csrc/spatial_attention_qk8.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:320", main=k3,
            path=launches_int8),
        "attention_head_major": dict(
            source="video_depth_anything_torch/csrc/attention_head_major.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:425", main=k4,
            path=launches_k4),
        "spatial_attention_qkv_fused": dict(
            source="video_depth_anything_torch/csrc/spatial_attention.cu",
            replaces="video_depth_anything_tpu/ops/pallas_attention.py:145", main=k5,
            path=launches_k5),
        "fused_rcu": dict(
            source="video_depth_anything_torch/csrc/fused_rcu.cu",
            replaces="video_depth_anything_tpu/ops/pallas_conv.py:125", main=k6,
            path=launches_k6),
        "phase_probes": dict(
            source="video_depth_anything_torch/csrc/phase_probes.cu",
            replaces="tools/bench_kernel_phases.py:140", main=probe_entries["phase_probes"],
            path=launches_tools),
        "attention_variants": dict(
            source="video_depth_anything_torch/csrc/attention_variants.cu",
            replaces="tools/bench_kernel_phases.py:263",
            main=probe_entries["attention_variants"], path=launches_tools),
        "qk_probes": dict(
            source="video_depth_anything_torch/csrc/qk_probes.cu",
            replaces="tools/bench_kernel_ab.py:122", main=probe_entries["qk_probes"],
            path=launches_tools),
    }
    kernels = []
    for name, m in meta.items():
        e = m["main"]
        fp32 = None if name in bf16_only else errs[(name, "float32")]
        ops = sass[os.path.basename(m["source"])[:-len(".cu")]]
        kernels.append({
            "name": name, "route": "cuda", "source": m["source"], "replaces": m["replaces"],
            "launches": m["path"][name],
            "sass": {op.lower(): n for op, n in ops.items()},
            "launches_int8_first_call": launches_int8[name],
            "launches_long_video_c2": launches_long[name],
            "launches_long_video_int8_c2": launches_long_int8[name],
            "max_abs_err": max(errs[(name, "bfloat16")], fp32 or 0.0),
            "max_abs_err_bf16": errs[(name, "bfloat16")],
            "max_abs_err_fp32": fp32,
            "tolerance": TOL[name],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "shape": e["shape"], "heads": e.get("heads"), "dtype": e["dtype"],
            **{key: e[key] for key in ("library", "probes", "schedules", "derived",
                                       "ratio", "k1_ms", "k1_mxu_denom_ms", "switches_ms")
               if key in e},
            **({"options_source": "video_depth_anything_torch/csrc/attention_switches.cu"}
               if name in ("spatial_attention", "attention_head_major",
                           "spatial_attention_qkv_fused") else {}),
        })
    print("long video and bench summary: " + json.dumps(
        {"long_video": long_timings, "bench": bench_record}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(cardname, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
