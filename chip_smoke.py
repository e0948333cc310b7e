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
      Fails if K1's, K4's, K6's, K7's, the option instances' (K1/K4/K5's
      mxu_denom and exp2), T1's, T2's or T3's library lacks HGMMA or
      UTMALDG, K3's IGMMA or UTMALDG, K2's or K2's backward's HMMA, if T2's,
      T3's or K7's has HMMA (none runs mma.sync), or if cuobjdump is missing.
  (c) K1 spatial attention against its plain version, bf16 and fp32, at
      the encoders' shapes, vitg's [32, 1370, 1536] H 24 (and S 1371)
      among them (strided views of a fused qkv, as the model passes them); then the switches: K1 with mxu_denom, exp2 and both,
      K4 and K5 with mxu_denom, each against its plain version with the
      same switches, K1's times (and its plain version's, per switch) at
      the main path's shape beside the default's.
  (c') K3 int8-QK spatial attention against its plain version, bf16 and
      fp32 v, at the same shapes (vitg's 24 heads included) (random int8 q and k, v a column view of
      a fused qkv), and its odd-head fallback (K1 on dequantized q, k).
  (c'') K4 head-major attention against its plain version, bf16 and fp32:
      head-major [32, 16, 1370, 64], split-head views of a vits fused qkv,
      dh = 32 at [32, 12, 1370, 32] and dh = 128 with an odd head count.
  (c''') K5 fused-qkv attention against its plain version at the vits and
      vitl 518^2 shapes, K1's time on the same views beside it; then its
      path (the entry called once per shape) with launch counts.
  (d) K2 temporal attention against its plain version at every motion
      module shape of vits, vitl and vitg (C 1536 dh 192, C 384 dh 48) at
      518x518 and of vits at 518x686 (the main path's), T = 32 and T = 4; its times (and SDPA's) replayed from
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
      (tools/bench_rcu.py) at the four vitl 518^2 RefineNet shapes and
      vitg's four (C 384, the kernel's widest) in bf16 (error against the
      plain version, K6 and the two-conv path timed),
      fp32 at two smaller shapes; then the vitl RefineNet cascade at full
      width on the taps of a 1x32x518x518 window, refinenet4 -> 1 with
      motion modules 2 and 3 between, once with use_kernel=True (7 K6
      launches) and once without (none), both timed and compared.
  (h') K7, the output head's tail (upsample, 3x3 to 32, ReLU, 1x1), at the
      benchmark's window shapes (vitl C 1, vits C 4, 518x924) against its
      plain version (max err / max |y| within 2e-2), the kernel, the plain
      version, cuDNN's conv with PyTorch's tail, the whole output stage and
      each stage it replaced timed (tools/bench_head_tail.py).
  (h'') K8, vitg's SwiGLU gate (silu(x1) * x2), on w12's bf16 output of
      one window at the benchmark's 518x924 ([32, 2443, 8192]) and at
      518x518 ([32, 1370, 8192]) against its plain version (PyTorch's two
      operators), bit for bit; both timed beside K8's byte bound.
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
  (k) vitg and the serving variants: vitg at full width (1.13 B encoder
      parameters drawn on the card) through VideoDepthPipeline on a 44-frame
      518x518 video (two windows), bf16 (40 K1 and 40 K8 per encode, 8 K2
      per head), fp32 and int8 (40 K3 and 40 K8 per encode, 40 K8 in the
      calibration forward), peak memory of each; bf16 held to
      twice the drift budget of the card's fp32, int8 to limits set from
      card readings, end to end and each of the 40 blocks on its own
      (see vitg_path); vitg's RefineNet cascade with and
      without K6 (7 launches at C 384); vitg's width cut to 4 blocks on the
      reduced clip, fp32 within 1e-3 of the CPU plain path and int8 within
      twice the flip floor of the CPU plain int8 (uncapped); one vits window each for
      use_bn, use_clstoken and pe="rope", fp32, within 1e-3 of the CPU;
      vitl metric on (e)'s video: the stitch applies no affine map, bf16
      within the drift budget of fp32, 16 EXR frames (zip and none) and one
      frame's PLY read back bit for bit.
  (n) the training path, after (k): K2 under a gradient (the autograd
      Function: K2 forward, the backward kernel of
      csrc/temporal_attention_backward.cu, one launch per backward) at
      vits's four motion-module shapes at T = 20, vitl's dh 128 and dh 32
      at T = 32 and T = 1, bf16 and fp32: output against the plain version
      at K2's tolerance, dq / dk / dv within K2's tolerance of the plain
      version's autograd and of the closed-form gradient, relative to each
      gradient's max |g|; bf16 timed per shape (the kernel from a CUDA
      graph, the plain recomputation, the Function's backward, SDPA's
      forward and backward, the bound and the exponentials' own time), a
      line on the earlier warp-per-item design (not in the build: expected
      bit for bit, measured by tools/bench_wgmma.py --compare); K1 (and its
      launch), K3, K4, K5 and K6 raise under a gradient and launch nothing;
      one fp32 train step (vits
      full width and depth, 20 frames at 112^2, TF32 off; the weights and
      clip of tools/bench_train_step.py) on the card against the CPU plain
      path, which takes the card's side at every ReLU and |.| kink
      (utils/kinks.py; a side moved only at an input within 1e-4 of its
      map's max of 0): loss within 1e-4 relative, every head gradient
      within 1e-3 of its leaf's max, no head tensor with a zero gradient but refinenet4's
      unused first unit (0 in JAX too), 12 K1, 8 K2 and 8 K2 backward
      launches; 9 steps
      at lr 1e-4 lower the loss, each step's loss differs and a gradient
      passes the final ReLU at each, the encoder unchanged bit for bit;
      the full-size step (vits, 1x20x518x518, bf16 with fp32 masters,
      lstsq SSI + 10 TGM, lr 1e-4; tools/bench_train_step.py, 2 warm
      steps, the median of 5): ms per step split into encoder, head
      forward and loss, backward and optimizer, the K2 backward's ms and
      share (and its kernel's per step), peak memory, launches per step
      (the K2 backward's 8 among them), every loss finite and
      different, a gradient through the final ReLU at each step; a
      checkpoint of that state loaded into another, the next step of each
      equal bit for bit, with a new loss and a gradient through the ReLU.
  (o) the data-parallel path, after (n), at world size 1 over NCCL (the
      machine has one card, and NCCL takes one card per rank; more ranks
      are held on the CPU with gloo, tests/test_torch_parallel.py):
      parallel.distributed.initialize over tcp://127.0.0.1, make_mesh(),
      then (e)'s video through VideoDepthPipeline(mesh=...) at
      windows_per_batch 2, bit for bit with the pipeline without a mesh at
      C = 2, K1 and K2 launched; ms/frame of both (in turns) and the
      all_gather per chunk (CUDA events); int8 the same (the mesh run
      calibrates and writes the side file once, K3 launched, the run
      without a mesh reads it: bit for bit); three distributed train steps
      (vits 1x20x518x518 bf16, tools/bench_train_step.py's weights and
      clip) against the steps without a mesh from the same state: loss and
      every head tensor bit for bit at each step, ms/step of both; the
      process group destroyed. A failure to start NCCL fails the run.
  (p) the mesh's model axis, after (o): K1 at vitl's 8 local heads [32,
      1370, 512] and vits' 3 [22, 1814, 192], K3 at vitl's 8 and K2 with
      4 local heads at vitl's and vits' motion modules (C/2: dh 128, 32;
      24, 48, 8), each against its plain version (bf16 timed beside its
      bound and SDPA); then two ranks on cuda:0 (this file started twice
      with --model-axis-rank; NCCL takes one card per rank, so gloo with
      CUDA tensors) on a (1, 2) mesh: vitl at full width (8 of 16 heads
      per rank) through VideoDepthPipeline(mesh=...) on (e)'s video at
      windows_per_batch 2 in bf16 (within the drift budget of the same
      pipeline without a mesh) and int8 (calibrating and writing its side
      file once; within twice the flip floor of the pipeline without a
      mesh on that file, and reported against it bit for bit), the reduced
      clip in fp32 (rtol = atol = 2e-4); three vits train steps at (n)'s
      setting in bf16 and in fp32 (every fp32 step's loss within 5e-4
      relative of the step without a mesh, every bf16 step's within the
      larger of 5e-4 and bf16's own distance from fp32 at that step; after
      three steps the share of the head's entries off by more than 1e-3
      of their leaf's max from the head trained without a mesh within the
      larger of 0.1 % and twice the sum-order floor's), the floor being the
      same runs without a mesh with every split unit's halves swapped
      (reported for the drift and the losses too); the two ranks bit for
      bit in every output, loss and gathered head; K1, K2 and K3 launch counts read around each mesh
      call. A rank that fails fails the run; its times are two processes
      sharing one card.
  (q) the serving artifact and the kernel build cache, after (p), through
      tools/bench_serving_artifact.py's measure: vitl at full width and
      depth (seeded random weights), 518x518, bf16, C = 1, its window
      program exported by torch.export on the card, saved, loaded and run
      against the live program (the pipeline's plain mode) on one random
      window: bit for bit, the launches per call equal to live's (24 K1,
      8 K2), its graph's vda:: nodes, ms per frame of both, export seconds
      and bytes; then vits int8 the same (12 K3, 8 K2, the int8 state dict
      equal to the pipeline's), and a vits int8 artifact traced on the CPU
      and moved to the card, equal to live (so to the card-traced one) with
      the same launches. Then tools/bench_compile_cache.py's measure: two
      fresh processes on one empty temporary cache directory, the cold one
      running an nvcc build per source and the warm one none; cold and warm
      seconds of the build and the first vits window. Before that, a vits
      artifact whose kernel libraries cannot be loaded must raise, as live
      does.
  (r) the stage and measurement tools of tools/, after (q), each once at
      its full-width default with only its timed repeats cut (one chain,
      or two timings for bench_residue; mxu_geometry at a 0.05 s margin):
      bench_ablate in its four modes, bench_segments, bench_head_fine and
      bench_temporal_swap on one vitl bf16 1x32x518x518 window, then
      bench_head_convs, bench_memory (vits and vitl, bf16 and fp32),
      bench_mxu_geometry, bench_int8_conv, bench_residue, bench_drift_518
      (vitl, 32 frames on numpy_state_dict(vitl, 0)'s weights, whose
      weights_sha256 it prints), drift_split on the same weights (a reading:
      vitl's bf16 drift all in bf16, the encoder alone, the head alone),
      bench_temporal_kernel, bench_stock_flash and bench_attn_kernel (both
      modes). Launch counts are read around each
      tool, and each kernel a tool times must have launched. Fails if
      ablate's unablated forward, or segments' timed stages composed (the
      head on its taps, then finish), is not VideoDepthAnything.forward's
      output bit for bit, if the forward after any variant is not (a stub
      left in place), if segments' taps are not the ones the forward hands
      its head, if
      a memory record's weights + frames are not the model's parameter and
      buffer bytes plus the window's exactly or its peak is not below the
      card's memory, if a GEMM rate reads over 105 % of its peak, if a
      drift number is not finite, if bf16's drift is over the budget (max 5 %
      / mean 0.2 % of the range) or int8's over VITL_INT8_MAX / _MEAN, if the
      weights' digest (drift_518's or drift_split's) is not VITL_NUMPY_SHA256,
      if a split number is not finite, or if an agreement that temporal_kernel,
      stock_flash or attn_kernel prints is over that kernel's TOL.
  (f) timing: one window forward at 1x32x518x518 in bf16 and in int8,
      vits, vitl and vitg, and the cached steady state per new frame for vits;
      then a torch.profiler breakdown of the vits window by kernel kind,
      bf16 and int8, and of the vitg window in bf16.
  (j) the port's bench (video_depth_anything_torch/bench.py) for vits at
      --iters 3 --warmup 1, run last: its record, which may hold no
      section error.
  (g) one JSON line {"kernels": [...]} (ten kernels, each with its
      launches summed over (r)'s tools, its launches per train step, on (p)'s mesh calls and per call of (q)'s
      artifacts, K1 / K2 / K3 with
      their local shapes' times; the K2 backward per vits train step, with
      each shape's times and errors), then the card's name and power
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
                 "head_output_tail": ("HGMMA", "UTMALDG"),
                 "spatial_attention": ("HGMMA", "UTMALDG"),
                 "attention_head_major": ("HGMMA", "UTMALDG"),
                 "attention_switches": ("HGMMA", "UTMALDG"),
                 "spatial_attention_qk8": ("IGMMA", "UTMALDG"),
                 "temporal_attention": ("HMMA",),
                 "temporal_attention_backward": ("HMMA",),
                 "phase_probes": ("HGMMA", "UTMALDG"),
                 "attention_variants": ("HGMMA", "UTMALDG"),
                 "qk_probes": ("HGMMA", "UTMALDG")}
# T2 is the attention body's instance, T3 a wgmma kernel: no mma.sync.
SASS_ABSENT = {"attention_variants": ("HMMA",), "qk_probes": ("HMMA",),
               "head_output_tail": ("HMMA",)}
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
       # dq, dk, dv against the plain version's autograd and the closed form,
       # relative to each gradient's max |g|: K2's tolerance.
       "temporal_attention_backward": {"bfloat16": "2e-2 max|g|", "float32": "1e-4 max|g|"},
       "attention_head_major": {"bfloat16": 4e-3, "float32": 1e-4},
       "spatial_attention_qkv_fused": {"bfloat16": 4e-3, "float32": 1e-4},
       "fused_rcu": {"bfloat16": "2^-7 max|y|", "float32": 1e-4},
       # K7's error is recorded over max |y|: against its plain version,
       # which rounds the conv before its bias (tests/test_torch_cuda.py
       # holds it to its own arithmetic at 4e-3).
       "head_output_tail": {"bfloat16": "2e-2 of max|y|"},
       # K8 rounds where PyTorch's silu and product round: bit for bit.
       "swiglu": {"bfloat16": 0.0},
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

# vitg int8 in (k), from tools/drift_limits.py on the card (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6). End to end against the card's fp32: the
# largest drift of four sound seeds (max 0.1091, mean 0.01339; this
# script's seed 0 reads 0.0671 / 0.00970). Block by block: sound blocks
# reach 0.0625 relative L2 on those seeds; one block's w3-input absmax x 4
# or x 1/8 lifts that block to 0.154-0.243, while end to end it moves
# int8's mean by 3-123 %.
VITG_INT8_MAX, VITG_INT8_MEAN = 0.11, 0.0135
VITG_INT8_BLOCK_L2 = 0.09

# vitl at 518 in (r), bench_drift_518 on numpy_state_dict(vitl, 0)'s weights
# (32 frames): the weights of the CPU comparison with the JAX package, whose
# digest tests/test_torch_drift_518.py pins. bf16 is held to the budget
# (utils/precision.py). int8 is held to a limit read on the card over four
# seeds (tools/bench_drift_518.py --numpy_weights 0-3; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §2, §6): the largest max (0.09962, seed 0) and mean
# (0.007183, seed 2) with 5 % above; on these weights JAX's own int8 drifts
# as far, so the weights set it, not the port.
VITL_NUMPY_SHA256 = "2897b7e0cd8e4a13d10e86506b39ef0c9e7dd3fd661ed1f9c3a66086f1610e8c"
VITL_INT8_MAX, VITL_INT8_MEAN = 0.105, 0.0075


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
              ("vitg 518^2", 32, 1370, 24), ("vitg S 1371", 32, 1371, 24),
              ("vits 518x686 cached", 22, 1814, 6)]
    vitg = None
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
                entry = dict(shape=[b, s, c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bms, bound_by=by)
                if name == "bfloat16" and label.endswith("cached") and layout == "strided qkv":
                    main = entry
                if name == "bfloat16" and label == "vitg 518^2":
                    vitg = entry
            del qkv, q, k, v
            torch.cuda.empty_cache()
    main["vitg"] = vitg
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
              ("vitg 518^2", 32, 1370, 24), ("vitg S 1371", 32, 1371, 24),
              ("vits 518x686 cached", 22, 1814, 6)]
    main = vitg = None
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
            entry = dict(shape=[b, s, c], heads=h, dtype=name, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by)
            if name == "bfloat16" and label.endswith("cached"):
                main = entry
            if name == "bfloat16" and label == "vitg 518^2":
                vitg = entry
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
    main["vitg"] = vitg
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
               "vitg 518^2": [(37 * 37, 1536), (19 * 19, 1536), (37 * 37, 384), (74 * 74, 384)],
               "vits 518x686": [(37 * 49, 192), (19 * 25, 384), (37 * 49, 64), (74 * 98, 64)]}
    main = vitg = None
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
                        entry = dict(shape=[p, t, c], heads=8, dtype=name, ms=ms,
                                     plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
                        if name == "bfloat16" and enc == "vits 518x686" and mod == 3:
                            main = entry
                        if name == "bfloat16" and enc == "vitg 518^2" and mod == 3:
                            vitg = entry   # C 384, dh 48
                    print(line, flush=True)
                    if not ok:
                        raise AssertionError(f"K2 {name} {enc} module {mod} T={t}: {said}")
                    record("temporal_attention", name, err)
                    del q, k, v, got, ref
    main["vitg"] = vitg
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
    """(h), first part: the bench tool at the four vitl shapes and the four
    vitg shapes (C 384, the kernel's widest) in bf16, fp32 at two smaller
    shapes; returns the entry of (32, 148, 148, 256), vitg's (32, 148, 148,
    384) under "vitg"."""
    import torch
    from video_depth_anything_torch.kernels import fused_rcu as k6
    from video_depth_anything_torch.tools import bench_rcu

    rows = bench_rcu.bench(bench_rcu.SHAPES + bench_rcu.VITG_SHAPES, iters=10)
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
        g = next(r for r in rows if r["shape"] == list(bench_rcu.VITG_SHAPES[0]))
        rcu = bench_rcu.random_unit(g["shape"][3], gen)
        x = torch.randn(g["shape"], device="cuda", generator=gen).to(torch.bfloat16)
        plain = time_ms(lambda: k6.fused_rcu_plain(x, *rcu.kernel_operands(x.dtype)), 3, 1)
        main["vitg"] = dict(shape=g["shape"], dtype="bfloat16", ms=g["kernel_ms"],
                            plain_ms=plain, library_ms=g["chain_ms"], bound_ms=g["bound_ms"],
                            bound_by=g["bound_by"])
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


def check_k7(record):
    """(h'): K7, the output head's tail, against its plain version at the
    benchmark's window shapes (tools/bench_head_tail.py: vitl at C 1, vits at
    C 4, 518x924), each stage of the path it replaced timed beside it;
    returns vitl's entry, vits's under "vits"."""
    from video_depth_anything_torch.tools import bench_head_tail

    rows = {name: bench_head_tail.bench(name) for name in bench_head_tail.SHAPES}
    for name, row in rows.items():
        if not row["err_over_max"] <= 2e-2:
            raise AssertionError(f"K7 {name}: max err / max |y| {row['err_over_max']:.3e} "
                                 f"over 2e-2")
        record("head_output_tail", "bfloat16", row["err_over_max"])

    def entry(row):
        n, (h, w, c), (oh, ow) = row["frames"], row["map"], row["out"]
        return dict(shape=[n, h, w, c, oh, ow], dtype="bfloat16", ms=row["k7_ms"],
                    plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    detail={k: row[k] for k in ("output_ms", "conv1_ms", "resize_ms",
                                                "conv2a_ms", "conv2b_ms", "k7_roofline_pct")})

    main = entry(rows["vitl-c1"])
    main["vits"] = entry(rows["vits-c4"])
    return main


def check_k8(gen, record):
    """(h''): K8, vitg's SwiGLU gate, against its plain version on one
    window's w12 output (hidden 4096; 2443 tokens a frame at 518x924, 1370
    at 518x518), bit for bit; each timed beside K8's bound (y read and h
    written once, bytes at the HBM rate). Returns the 518x924 entry, the
    518x518 one under "detail"."""
    import torch
    from video_depth_anything_torch.kernels import swiglu as k8

    rows = {}
    for name, tokens in (("518x924", 2443), ("518x518", 1370)):
        y = (2 * torch.randn(32, tokens, 8192, device="cuda", generator=gen)).to(torch.bfloat16)
        plain = k8.swiglu_plain(y)
        got = k8.swiglu(y)
        same = got.shape == plain.shape and torch.equal(got.view(torch.int16),
                                                        plain.view(torch.int16))
        err = (got.float() - plain.float()).abs().max().item()
        del got, plain
        if not same:
            raise AssertionError(f"K8 {name}: not bit for bit the plain version "
                                 f"(max abs err {err:.3e})")
        record("swiglu", "bfloat16", err)
        ms, plain_ms = time_ms(lambda: k8.swiglu(y), 20), time_ms(lambda: k8.swiglu_plain(y), 20)
        bms, by = bound_ms(0.0, y.numel() * 2 * 3 / 2)
        rows[name] = dict(shape=list(y.shape), dtype="bfloat16", ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=bms, bound_by=by,
                          roofline_pct=100 * bms / ms)
        print(f"(h'') K8 at {name} {list(y.shape)} bf16: bit for bit; {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, bound {bms:.4f} by {by}: {rows[name]['roofline_pct']:.1f} %)",
              flush=True)
        del y
    main = dict(rows["518x924"])
    main["detail"] = {"roofline_pct": main.pop("roofline_pct"), "518x518": rows["518x518"]}
    return main


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


def rcu_cascade(cardname, encoder="vitl", model=None):
    """(h), second part: the RefineNet cascade of ``encoder`` (vitl: 256
    features; vitg, from (k): 384) at full width on the taps of one
    1x32x518x518 window, with and without K6; returns the launch counts of
    the use_kernel=True run. ``model``: the encoder's bf16 model, else one
    is built."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import INFER_LEN, get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.utils.precision import MAX_ERR_FRAC, MEAN_ERR_FRAC

    if model is None:
        model = build_model(get_model_config(encoder), seed=0, device="cuda").to(torch.bfloat16)
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
    print(f"{encoder} RefineNet cascade bf16, 1x32x518x518 taps -> path_1 {tuple(got.shape)} on "
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
                temporal_attention=8 * n_win,               # 4 modules x 2 blocks
                head_output_tail=n_win)                     # K7: one per bf16 head
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
                        spatial_attention_qk8=depth * n_win,
                        head_output_tail=n_win + calib)
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
            expect = want(spatial_attention=depth * steps[c], temporal_attention=8 * steps[c],
                          head_output_tail=0 if fp32 else steps[c])
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
    if got != want(spatial_attention=depth, temporal_attention=16,
                   head_output_tail=2) or not same:
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
                    spatial_attention_qk8=depth * steps[2], head_output_tail=steps[2] + 1):
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


def vitg_path(cardname):
    """(k), first part: vitg at full width through the pipeline, bf16 and
    int8 (launch counts, peak memory), each against the card's fp32; vitg's
    RefineNet cascade with and without K6; vitg's width cut to 4 blocks on
    the reduced clip, fp32 against the CPU plain path within 1e-3 of the
    range and int8 against the CPU plain int8 within twice the flip floor.

    The drift budgets of utils/precision.py are toy-shape budgets. On these
    random weights at vitg's width the bf16 function misses the mean term
    by itself: tests/test_torch_vitg.py holds the port's bf16 drift to the
    JAX package's at vitg's width (both near the mean budget at 112²). So
    vitg bf16 is held to twice the budget, the JAX package's own
    serving-resolution finding (PARITY.md r5: the toy budgets hold at 518²
    within about 2x); four seeds read 0.0031-0.0042 mean (PERF.md §6).
    int8 is held end to end to VITG_INT8_MAX / VITG_INT8_MEAN and block by
    block to VITG_INT8_BLOCK_L2, both set from card readings; the flip
    floor on the cut is uncapped (there the floor itself reaches the int8
    budget). Returns (bf16 launches, int8 launches, cascade launches)."""
    import dataclasses

    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import INFER_LEN, VIT_CONFIGS, get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline, preprocess
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.tools.drift_limits import block_rel_l2
    from video_depth_anything_torch.utils.precision import (
        INT8_MAX_ERR_FRAC, INT8_MEAN_ERR_FRAC, MAX_ERR_FRAC, MEAN_ERR_FRAC, flip_floor_report,
        precision_drift_report, synthetic_video)

    cfg = get_model_config("vitg")
    depth, gib = cfg.vit.depth, 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda")     # drawn on the card
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"vitg: {n_par / 1e9:.3f} B parameters drawn on {cardname} in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / gib:.2f} GiB fp32",
          flush=True)
    pipe = VideoDepthPipeline(cfg, model)
    frames = synthetic_video(n=44, hw=(518, 518), seed=10)
    n_win = num_windows(len(frames))                    # 2: 32 frames, then 12 new
    encodes = n_win                                     # the keyframe cache: one encode a window

    def counted(p, **kw):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, _ = p.infer_video_depth(frames, **kw)
        torch.cuda.synchronize()
        return out, kernels.launch_counts(), time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() / gib

    d16, launches, wall, peak16 = counted(pipe)
    print(f"vitg bf16 cached, {len(frames)} frames 518x518, {n_win} windows in {wall:.2f} s "
          f"(first call) on {cardname}: launches {launches}, peak {peak16:.2f} GiB", flush=True)
    want = {name: 0 for name in launches}
    want.update(spatial_attention=depth * encodes, temporal_attention=8 * n_win,
                head_output_tail=n_win, swiglu=depth * encodes)
    if launches != want or d16.shape != frames.shape[:3] or not np.isfinite(d16).all():
        raise AssertionError(f"vitg bf16: launches {launches} (want {want}), shape {d16.shape}")
    d32, _, wall, peak32 = counted(pipe, fp32=True)
    rep = precision_drift_report(d16, d32)
    within = rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC
    print(f"vitg fp32 on the card: {wall:.2f} s, peak {peak32:.2f} GiB (the fp32 and bf16 "
          f"models resident); bf16 vs fp32 max {rep['max_err_frac']:.5f} / mean "
          f"{rep['mean_err_frac']:.6f} of depth range {rep['depth_range']:.4f} (budget "
          f"{MAX_ERR_FRAC} / {MEAN_ERR_FRAC}: {'within' if within else 'over'}; held to "
          f"twice it)", flush=True)
    if not (rep["max_err_frac"] < 2 * MAX_ERR_FRAC and rep["mean_err_frac"] < 2 * MEAN_ERR_FRAC):
        raise AssertionError(f"vitg bf16 drift over twice the budget: {rep}")

    pipe8 = VideoDepthPipeline(cfg, model, quant="int8")
    d8, launches8, wall, peak8 = counted(pipe8)
    want8 = {name: 0 for name in launches8}
    want8.update(spatial_attention=depth, temporal_attention=8 * (n_win + 1),   # + calibration
                 spatial_attention_qk8=depth * encodes, head_output_tail=n_win + 1,
                 swiglu=depth * (encodes + 1))
    rep8 = precision_drift_report(d8, d32)
    within = (rep8["max_err_frac"] < INT8_MAX_ERR_FRAC
              and rep8["mean_err_frac"] < INT8_MEAN_ERR_FRAC)
    print(f"vitg int8 (bf16 activations, calibrated on window 0) in {wall:.2f} s: launches "
          f"{launches8}, peak {peak8:.2f} GiB; int8 vs fp32 max {rep8['max_err_frac']:.5f} / "
          f"mean {rep8['mean_err_frac']:.6f} (toy budget {INT8_MAX_ERR_FRAC} / "
          f"{INT8_MEAN_ERR_FRAC}: {'within' if within else 'over'}; held to "
          f"{VITG_INT8_MAX} / {VITG_INT8_MEAN})", flush=True)
    if launches8 != want8 or d8.shape != frames.shape[:3] or not np.isfinite(d8).all():
        raise AssertionError(f"vitg int8 launches {launches8}, expected {want8}")
    if not (rep8["max_err_frac"] < VITG_INT8_MAX and rep8["mean_err_frac"] < VITG_INT8_MEAN):
        raise AssertionError(f"vitg int8 drift over {VITG_INT8_MAX} / {VITG_INT8_MEAN}: {rep8}")
    # Every one of the 40 int8 blocks on its own, against its bf16 block on
    # the bf16 stream's input (first window): a fault in one block's sites
    # or slots that the 39 others' noise hides end to end shows here.
    net_hw = preprocess.network_input_hw(518, 518, preprocess.effective_input_size(518, 518, 518))
    blocks = block_rel_l2(pipe.model_in(torch.bfloat16),
                          pipe8.quantized_model(frames[:INFER_LEN], net_hw, torch.bfloat16),
                          frames[:INFER_LEN], net_hw)
    worst = int(np.argmax(blocks))
    print(f"vitg int8 block by block (residual branch vs bf16, relative L2): "
          f"{min(blocks):.4f}-{blocks[worst]:.4f} (block {worst}); limit {VITG_INT8_BLOCK_L2}",
          flush=True)
    if len(blocks) != depth or not blocks[worst] < VITG_INT8_BLOCK_L2:
        raise AssertionError(f"vitg int8 block {worst}: relative L2 {blocks[worst]} "
                             f"(limit {VITG_INT8_BLOCK_L2}); all {blocks}")
    del pipe8
    launches_cascade = rcu_cascade(cardname, "vitg", pipe.model_in(torch.bfloat16))
    del pipe, model
    torch.cuda.empty_cache()

    # vitg's width cut to 4 blocks (taps 0..3): fp32 on the card against the
    # CPU plain path on the reduced clip (the depth cut keeps the CPU side short).
    cut = get_model_config("vitg", taps=(0, 1, 2, 3),
                           vit_override=dataclasses.replace(VIT_CONFIGS["vitg"], depth=4))
    small_model = build_model(cut, seed=0, device="cuda")
    small = synthetic_video(n=40, hw=(140, 196), seed=5)
    kernels.reset_launch_counts()
    g32, _ = VideoDepthPipeline(cut, small_model).infer_video_depth(small, input_size=112, fp32=True)
    small_launches = kernels.launch_counts()
    t0 = time.perf_counter()
    c32, _ = VideoDepthPipeline(cut, copy.deepcopy(small_model).to("cpu"), device="cpu"
                                ).infer_video_depth(small, input_size=112, fp32=True)
    rng = float(c32.max() - c32.min())
    err = float(np.abs(g32 - c32).max()) / max(rng, 1e-12)
    print(f"vitg width, 4 blocks, fp32: card vs CPU plain path on 40 frames 140x196 (input "
          f"112): max {err:.3e} of depth range {rng:.4f} (tol 1e-3); card launches "
          f"{small_launches}; CPU {time.perf_counter() - t0:.1f} s", flush=True)
    if not err < 1e-3 or small_launches["spatial_attention"] != 4 * num_windows(len(small)):
        raise AssertionError(f"vitg 4-block card vs CPU: {err}, launches {small_launches}")

    # int8 on the cut: the card and the CPU plain path on one side file,
    # held to twice the flip floor (the CPU run with every absmax x (1 + 1e-6)).
    tmp = tempfile.mkdtemp(prefix="vda_vitg_int8_")
    try:
        spath, npath = os.path.join(tmp, "cut.int8calib.npz"), os.path.join(tmp, "nudged.npz")
        kernels.reset_launch_counts()
        g8, _ = VideoDepthPipeline(cut, small_model, quant="int8", calib_path=spath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
        cut_launches8 = kernels.launch_counts()
        cpu_model = copy.deepcopy(small_model).to("cpu")
        c8, _ = VideoDepthPipeline(cut, cpu_model, device="cpu", quant="int8", calib_path=spath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
        scale_side_file(spath, npath, 1 + 1e-6)
        n8, _ = VideoDepthPipeline(cut, cpu_model, device="cpu", quant="int8", calib_path=npath
                                   ).infer_video_depth(small, input_size=112, fp32=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Uncapped: at vitg's width the floor's own mean (the CPU against itself)
    # reaches the int8 budget, which as a cap would reject the CPU run too.
    ff = flip_floor_report(g8, c8, n8, cap=False)
    print(f"vitg width, 4 blocks, int8 (fp32 activations, one side file): card vs CPU plain "
          f"int8 aligned max {ff['got']['max_err_frac']:.5f} / mean "
          f"{ff['got']['mean_err_frac']:.6f}, relative L2 {ff['got']['rel_l2']:.3e}; flip floor "
          f"{ff['floor']['max_err_frac']:.5f} / {ff['floor']['mean_err_frac']:.6f} / "
          f"{ff['floor']['rel_l2']:.3e}; limits (twice the floor) "
          f"{ff['limit']['max_err_frac']:.5f} / {ff['limit']['mean_err_frac']:.6f} / "
          f"{ff['limit']['rel_l2']:.3e}; card launches {cut_launches8}", flush=True)
    if not ff["ok"] or cut_launches8["spatial_attention_qk8"] != 4 * num_windows(len(small)):
        raise AssertionError(f"vitg 4-block int8 card vs CPU: {ff}, launches {cut_launches8}")
    del small_model, cpu_model
    torch.cuda.empty_cache()
    return launches, launches8, launches_cascade


def variants_path(cardname):
    """(k), second part: one vits window (22 frames 140x196, input 112) for
    each head variant, use_bn, use_clstoken and pe="rope", fp32 on the card
    against the CPU plain path within 1e-3 of the range; launch counts."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.utils.precision import synthetic_video

    frames = synthetic_video(n=22, hw=(140, 196), seed=11)   # one window
    for over in (dict(use_bn=True), dict(use_clstoken=True), dict(pe="rope")):
        cfg = get_model_config("vits", **over)
        model = build_model(cfg, seed=0, device="cuda")
        kernels.reset_launch_counts()
        got, _ = VideoDepthPipeline(cfg, model).infer_video_depth(frames, input_size=112, fp32=True)
        launches = kernels.launch_counts()
        ref, _ = VideoDepthPipeline(cfg, copy.deepcopy(model).to("cpu"), device="cpu"
                                    ).infer_video_depth(frames, input_size=112, fp32=True)
        rng = float(ref.max() - ref.min())
        err = float(np.abs(got - ref).max()) / max(rng, 1e-12)
        print(f"variant {over}: vits, one window, fp32 on {cardname} vs CPU plain path: max "
              f"{err:.3e} of depth range {rng:.4f} (tol 1e-3); launches {launches}", flush=True)
        want = {name: 0 for name in launches}
        want.update(spatial_attention=cfg.vit.depth, temporal_attention=8)
        if launches != want or not err < 1e-3:
            raise AssertionError(f"variant {over}: error {err}, launches {launches}")


def metric_path(cardname):
    """(k), third part: vitl metric on (e)'s video. The stitch applies no
    affine map (every frame equals the clamped, cross-faded window
    depths); bf16 against fp32 within the drift budget; EXR frames (zip
    and none) and one frame's PLY read back bit for bit. The pipeline, not
    the CLI: the card's machine has no cv2. Returns the bf16 launches."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline, stitch
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.utils.exr import read_exr_z, write_exr_batch
    from video_depth_anything_torch.utils.pointcloud import read_ply, unproject_depth, write_ply
    from video_depth_anything_torch.utils.precision import (
        MAX_ERR_FRAC, MEAN_ERR_FRAC, precision_drift_report, synthetic_video)

    cfg = get_model_config("vitl", metric=True)
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    frames = synthetic_video(n=100, hw=(480, 640), seed=3)
    n_win = num_windows(len(frames))
    windows = []
    first, step = stitch.stitch_first, stitch.stitch_step

    def spy_first(d):
        windows.append(d.float().cpu().numpy())
        return first(d)

    def spy_step(carry, d, metric=False):
        windows.append(d.float().cpu().numpy() if metric else None)
        return step(carry, d, metric=metric)

    stitch.stitch_first, stitch.stitch_step = spy_first, spy_step
    try:
        kernels.reset_launch_counts()
        d16, _ = pipe.infer_video_depth(frames)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        stitch.stitch_first, stitch.stitch_step = first, step
    if len(windows) != n_win or any(w is None for w in windows):
        raise AssertionError(f"metric stitch: {len(windows)} windows seen, metric flag lost")
    w = [np.maximum(x, 0) for x in windows]
    fade = np.array([0.0] + [i / 7 for i in range(1, 7)] + [1.0], np.float32)[:, None, None]
    want, tail = [w[0][:24]], w[0][-8:]
    for d in w[1:]:
        want += [tail * (1 - fade) + d[2:10] * fade, d[10:24]]
        tail = d[-8:]
    want = np.concatenate(want + [tail])[:len(frames)]
    stitch_err = float(np.abs(d16 - want).max())
    d32, _ = pipe.infer_video_depth(frames, fp32=True)
    rep = precision_drift_report(d16, d32)
    print(f"metric vitl bf16, {len(frames)} frames 480x640, {n_win} windows on {cardname}: "
          f"launches {launches}; stitched vs clamped cross-faded windows max |d| "
          f"{stitch_err:.3e} (tol 1e-6 of max {float(want.max()):.4f}); bf16 vs fp32 max "
          f"{rep['max_err_frac']:.5f} / mean {rep['mean_err_frac']:.6f} (budget "
          f"{MAX_ERR_FRAC} / {MEAN_ERR_FRAC})", flush=True)
    want_l = {name: 0 for name in launches}
    want_l.update(spatial_attention=cfg.vit.depth * n_win, temporal_attention=8 * n_win,
                  head_output_tail=n_win)
    if launches != want_l or not stitch_err <= 1e-6 * float(want.max()):
        raise AssertionError(f"metric path: launches {launches}, stitch error {stitch_err}")
    if not (rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC):
        raise AssertionError(f"metric bf16 drift over budget: {rep}")
    tmp = tempfile.mkdtemp(prefix="vda_metric_")
    try:
        sizes = {}
        for comp in ("zip", "none"):
            paths = [os.path.join(tmp, f"{comp}_{i:05d}.exr") for i in range(16)]
            write_exr_batch(paths, d16[:16], compression=comp)
            sizes[comp] = sum(os.path.getsize(p) for p in paths)
            bad = [i for i, p in enumerate(paths) if not np.array_equal(read_exr_z(p), d16[i])]
            if bad:
                raise AssertionError(f"EXR {comp}: frames {bad} read back unequal")
        ply = os.path.join(tmp, "point0007.ply")
        pts, cols = unproject_depth(d16[7], 470.4, 470.4, frames[7])
        write_ply(ply, pts, cols)
        rp, rc = read_ply(ply)
        if not (np.array_equal(rp, pts.astype(np.float32)) and np.array_equal(rc, cols)):
            raise AssertionError("PLY read back unequal")
        print(f"metric outputs: 16 EXR frames read back bit for bit, zip {sizes['zip']} bytes, "
              f"none {sizes['none']}; PLY of frame 7 ({len(pts)} points) read back equal",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del pipe
    torch.cuda.empty_cache()
    return launches


# Parameters the head's forward never reaches: refinenet4 fuses no skip, so
# its first residual unit is unused (as in the reference); their gradient
# is 0 in the JAX package too.
UNREACHED = ("scratch.refinenet4.resConfUnit1.",)
# The last conv's bias: while every output is above the final ReLU its
# gradient is 0 in exact arithmetic (the SSI and TGM losses do not see a
# shift), and each side reads the rounding of a sum that cancels. It is held
# to that 0 (within 1e-3 of the largest head gradient, on both sides), not
# to the other side's rounding, and left out of the non-zero check.
SHIFT_FREE = "scratch.output_conv2.2.bias"
# The fp32 train step's head gradients, card against CPU: every leaf within
# this fraction of its max |g|. The CPU takes the card's side at every kink
# (utils/kinks.py: a ReLU or |.| input within rounding of 0 may take either
# side, and one such pixel moves an upstream leaf's gradient by up to 1e-2);
# a side it moves must be at an input within KINK_X of its map's max |x| of
# 0, 100 times the fp32 agreement of the loss, so a kernel that computed
# another function could not hide behind the replay.
GRAD_TOL = 1e-3
KINK_X = 1e-4
# A vits train step's launches: the frozen encoder's 12 K1, and each of the
# four motion modules' two attention blocks' K2 forward and backward.
TRAIN_STEP_LAUNCHES = {"spatial_attention": 12, "temporal_attention": 8,
                       "temporal_attention_backward": 8}


# The K2 backward's design before its tiles (a warp per (pixel, head), one
# item loaded, computed and stored at a time).
EARLIER_DESIGN = ("not compared here, as this build keeps no copy of it; each item keeps "
                  "that design's arithmetic (the same products summed in the same order, "
                  "padded frame columns adding exact zeros), so dq / dk / dv are expected bit "
                  "for bit; tools/bench_wgmma.py --k2_backward --compare DIR measures the max "
                  "abs difference between two trees")


def k2_closed_form_grads(q, k, v, do, num_heads, scale):
    """dq, dk, dv of K2's function in closed form, float64, apart from
    autograd: P = softmax(qs k^T) with qs = q * scale_in(q's dtype, scale);
    dv = P^T do; ds = P o (do v^T - rowsum(do o o)); dq = ds k * scale;
    dk = ds^T qs. In float64 its own rounding stays out of the fp32
    comparison: in fp32 it reads about 4e-7 of max |g| where the exact
    dq and dk are 0 (T = 1)."""
    import torch
    from video_depth_anything_torch.ops.attention import scale_in

    p, t, c = q.shape
    sc = scale_in(q.dtype, scale)

    def heads(x):
        return x.double().reshape(p, t, num_heads, c // num_heads).transpose(1, 2)

    qh, kh, vh, doh = map(heads, (q, k, v, do))
    prob = torch.softmax((qh * sc) @ kh.transpose(-1, -2), -1)
    ds = prob * (doh @ vh.transpose(-1, -2) - (doh * (prob @ vh)).sum(-1, keepdim=True))
    grads = ((ds @ kh) * sc, ds.transpose(-1, -2) @ (qh * sc), prob.transpose(-1, -2) @ doh)
    return [g.transpose(1, 2).reshape(p, t, c) for g in grads]


def training_path(cardname, record):
    """(n): the training path. K2 under a gradient (its forward and its
    backward kernel) against its plain version and the closed form, and the
    forward-only kernels refusing one; one fp32 train step
    on the card against the CPU plain path (vits, 20 frames at 112^2);
    the full-size bf16 step timed (tools/bench_train_step.py); a
    checkpoint's continuation bit for bit. Returns (the full-size step's
    record, the backward kernel's entry)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.kernels import attention_head_major as k4
    from video_depth_anything_torch.kernels import fused_rcu as k6
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
    from video_depth_anything_torch.kernels import spatial_attention_qkv as k5
    from video_depth_anything_torch.kernels import temporal_attention as k2
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.tools import bench_train_step as bts
    from video_depth_anything_torch.training import checkpoint as ckpt
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.utils import kinks

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    # 1. K2 under a gradient: the Function's output against the plain
    # version at K2's tolerance; its dq / dk / dv, from the backward kernel
    # (one launch per backward), held to the plain version's autograd and
    # to the closed-form gradient at K2's tolerance relative to each
    # gradient's max |g| (floored at 1e-3 of the largest of the three: at
    # T = 1 the softmax is constant and dq, dk are 0). vits's four motion
    # modules at the train step's T = 20, vitl's dh 128 and dh 32 at T = 32,
    # and T = 1. bf16 timed: the kernel per call (a CUDA graph's replay),
    # the plain version's recomputation, the Function's backward called
    # back to back, SDPA's forward and backward on the split heads.
    shapes = [("vits module 0", 37 * 37, 20, 192), ("vits module 1", 19 * 19, 20, 384),
              ("vits module 2", 37 * 37, 20, 64), ("vits module 3", 74 * 74, 20, 64),
              ("vitl module 0", 37 * 37, 32, 1024), ("vitl module 2", 37 * 37, 32, 256),
              ("vits module 0, T 1", 37 * 37, 1, 192)]
    grad_err, per_shape, step_keys = {}, {}, []   # step_keys: the train step's four modules
    exps = {}   # the exponentials' own ms per shape (P recomputed: P * H * T^2), not measured

    def rel_errs(got, ref):
        floor = 1e-3 * max(r.double().abs().max().item() for r in ref)
        return [(g.double() - r.double()).abs().max().item()
                / max(r.double().abs().max().item(), floor) for g, r in zip(got, ref)]

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for label, p, t, c in shapes:
            dh = c // 8
            x = [torch.randn(p, t, c, device="cuda", generator=gen).to(dt) for _ in range(4)]
            a = [u.clone().requires_grad_() for u in x[:3]]
            b = [u.clone().requires_grad_() for u in x[:3]]
            o = k2.temporal_attention(*a, num_heads=8, scale=dh ** -0.5)
            ref = k2.temporal_attention_plain(*b, num_heads=8, scale=dh ** -0.5)
            if o.grad_fn is None or "TemporalAttentionFunction" not in o.grad_fn.name():
                raise AssertionError(f"K2 under grad: output has grad_fn {o.grad_fn}")
            kernels.reset_launch_counts()
            o.backward(x[3], retain_graph=True)
            torch.cuda.synchronize()
            launched = {n: k for n, k in kernels.launch_counts().items() if k}
            ref.backward(x[3])
            err, ok, said = held("temporal_attention", name, o.detach(), ref.detach())
            tol = tolerance("temporal_attention", name, ref)
            got = [u.grad for u in a]
            vs_plain = rel_errs(got, [w.grad for w in b])
            vs_exact = rel_errs(got, k2_closed_form_grads(*x[:3], x[3], 8, dh ** -0.5))
            abs_err = max((u.grad.float() - w.grad.float()).abs().max().item()
                          for u, w in zip(a, b))
            ok = (ok and launched == {"temporal_attention_backward": 1}
                  and max(vs_plain) <= tol and max(vs_exact) <= tol
                  and all(bool(torch.isfinite(g).all()) for g in got))
            grad_err[name] = max(grad_err.get(name, 0.0), *vs_plain, *vs_exact)
            record("temporal_attention_backward", name, abs_err)
            key = f"{label} [{p},{t},{c}] dh {dh}"
            line = (f"K2 under grad {name:8s} {key}: o {said}; backward kernel launches "
                    f"{launched}; dq/dk/dv against the plain autograd, max err / max |g| "
                    f"{', '.join(f'{r:.2e}' for r in vs_plain)} (max abs {abs_err:.3e}); against "
                    f"the closed form {', '.join(f'{r:.2e}' for r in vs_exact)} (tol {tol:.3g})")
            if name == "bfloat16":
                q, k, v, do = (u.detach() for u in (*a, x[3]))
                e = {"ms": graph_ms(lambda: k2.temporal_attention_backward(
                         q, k, v, do, num_heads=8, scale=dh ** -0.5), 20),
                     "plain_ms": time_ms(lambda: k2.temporal_attention_backward_plain(
                         q, k, v, do, num_heads=8, scale=dh ** -0.5), 5, 1),
                     "function_ms": time_ms(
                         lambda: torch.autograd.grad(o, a, x[3], retain_graph=True), 5, 1)}
                # The least the backward can take: q, k, v, do read once and
                # dq, dk, dv written once; five [T x T x dh] products per
                # (pixel, head): QK^T again, dV = P^T dO, dP = dO V^T,
                # dQ = dS K, dK = dS^T Q. The library: SDPA's forward and
                # backward on the same [P, H, T, dh] inputs.
                e["bound_ms"], e["bound_by"] = bound_ms(10 * p * t * t * c, 7 * p * t * c * 2)
                exps[key] = exp_ms(p * 8 * t * t)
                heads = [u.unflatten(-1, (8, dh)).transpose(1, 2).requires_grad_()
                         for u in (q, k, v)]
                do_h = do.unflatten(-1, (8, dh)).transpose(1, 2)
                e["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(*heads, scale=dh ** -0.5), heads, do_h), 5, 1)
                per_shape[key] = e
                if t == 20:
                    step_keys.append(key)
                del heads, do_h
                line += (f"; kernel {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms, "
                         f"{e['bound_by']}; exponentials alone {exps[key]:.4f} ms), plain "
                         f"{e['plain_ms']:.4f} ms, the Function's "
                         f"backward {e['function_ms']:.4f} ms, SDPA forward and backward "
                         f"{e['library_ms']:.4f} ms")
            print(line, flush=True)
            if not ok:
                raise AssertionError(f"K2 under grad {name} {key}: {said}, launches {launched}, "
                                     f"against plain {vs_plain}, closed form {vs_exact}")
            del x, a, b, o, ref, got
    print(f"K2 backward against the earlier warp-per-item design: {EARLIER_DESIGN}", flush=True)
    # The forward-only kernels refuse a gradient, launching nothing.
    dt = torch.bfloat16
    qkv = torch.randn(2, 77, 3 * 384, device="cuda", generator=gen).to(dt).requires_grad_()
    q, k, v = qkv.split(384, dim=-1)
    q8, k8 = (torch.randint(-127, 128, (2, 77, 384), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(2))
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    xr = torch.randn(1, 8, 8, 256, device="cuda", generator=gen).to(dt).requires_grad_()
    w = k6.kernel_weight(torch.randn(256, 256, 3, 3, device="cuda", generator=gen) * 0.02, dt)
    bias = torch.zeros(256, device="cuda")
    refusals = {
        "K1 spatial_attention": lambda: k1.spatial_attention(q, k, v, num_heads=6, scale=0.125),
        "K1 launch": lambda: k1.launch(q, k, v, num_heads=6, scale=0.125),
        "K3 spatial_attention_qk8": lambda: k3.spatial_attention_qk8(q8, k8, v, scales,
                                                                     num_heads=6),
        "K4 attention_head_major": lambda: k4.attention_head_major(
            *(t.unflatten(-1, (6, 64)).transpose(1, 2) for t in (q, k, v)), scale=0.125),
        "K5 spatial_attention_qkv_fused": lambda: k5.spatial_attention_qkv_fused(qkv, num_heads=6),
        "K6 fused_rcu": lambda: k6.fused_rcu(xr, w, bias, w, bias),
    }
    kernels.reset_launch_counts()
    for label, call in refusals.items():
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{label} ran under a gradient")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"a refusing wrapper launched: {kernels.launch_counts()}")
    print(f"K1 (and its launch), K3, K4, K5, K6 refuse a gradient: {len(refusals)} calls "
          f"raised, nothing launched", flush=True)

    # 2. One fp32 step, card against CPU: vits full width and depth, 20
    # frames at 112^2, the same seeded weights and batch
    # (tools/bench_train_step.py's, whose outputs stay above the final
    # ReLU); then 8 more steps at the configuration's lr 1e-4.
    cfg = get_model_config("vits", num_frames=20)
    tc = ts.TrainConfig(compute_dtype="float32", learning_rate=1e-4, epochs=1,
                        steps_per_epoch=9)
    model = bts.synthetic_model(cfg, 0)
    gpu = ts.create_train_state(copy.deepcopy(model).to("cuda"), tc)
    cpu = ts.create_train_state(model, tc)
    batch = bts.synthetic_batch(1, 20, 112, "cpu", seed=3)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    enc_before = {k: t.clone() for k, t in gpu.model.pretrained.state_dict().items()}
    kernels.reset_launch_counts()
    sides, flips = [], []
    with kinks.record(sides):
        gpu, gm = ts.train_step(gpu, gbatch, cfg, tc)
    torch.cuda.synchronize()
    fp32_launches = {n: c for n, c in kernels.launch_counts().items() if c}
    with kinks.replay(sides, flips):
        cpu, cm = ts.train_step(cpu, batch, cfg, tc)
    del sides
    moved, moved_x = sum(n for n, _ in flips), max(x for _, x in flips)
    loss_rel = abs(float(gm["loss"]) - float(cm["loss"])) / abs(float(cm["loss"]))
    gmax = max(t.grad.abs().max().item() for t in cpu.head.values())
    errs, dead = [], []
    for name, t in gpu.head.items():
        g, r = t.grad.float().cpu(), cpu.head[name].grad
        if name == SHIFT_FREE:
            shift = max(g.abs().max().item(), r.abs().max().item()) / gmax
            continue
        errs.append(((g - r).abs().max().item() / max(r.abs().max().item(), 1e-3 * gmax), name))
        if not name.startswith(UNREACHED) and not g.abs().max() > 0:
            dead.append(name)
    errs.sort(reverse=True)
    worst = errs[0]
    unreached = [n for n in gpu.head if n.startswith(UNREACHED)]
    losses = [float(gm["loss"])]
    out_grad = [gpu.head[bts.OUTPUT_WEIGHT].grad.abs().max().item()]
    for _ in range(8):
        gpu, m = ts.train_step(gpu, gbatch, cfg, tc)
        losses.append(float(m["loss"]))
        out_grad.append(gpu.head[bts.OUTPUT_WEIGHT].grad.abs().max().item())
    enc_same = all(torch.equal(t, enc_before[k]) for k, t in gpu.model.pretrained.state_dict().items())
    print(f"fp32 train step, vits 1x20x112x112, card vs CPU: loss {losses[0]:.6f} vs "
          f"{float(cm['loss']):.6f} (rel {loss_rel:.2e}, tol 1e-4); the CPU took the card's side at "
          f"{len(flips)} kinks, moving {moved} entries at |x| up to {moved_x:.1e} of the map's max "
          f"(tol {KINK_X}); head gradients, error over the leaf's "
          f"max: median {errs[len(errs) // 2][0]:.2e}, worst "
          + ", ".join(f"{e:.2e} {n}" for e, n in errs[:5]) + f" (tol {GRAD_TOL}); "
          f"{len(gpu.head) - len(unreached) - 1}"
          f" head tensors, none with a zero gradient: {not dead} (the {len(unreached)} of "
          f"refinenet4's unused first unit are 0 on both sides; the output bias, shift-free, "
          f"reads {shift:.1e} of the largest gradient, tol 1e-3); launches {fp32_launches}; "
          f"9 steps at lr 1e-4: losses {', '.join(f'{x:.5f}' for x in losses)}, the last conv's "
          f"largest weight gradient {', '.join(f'{x:.2e}' for x in out_grad)}; encoder "
          f"unchanged bit for bit: {enc_same}", flush=True)
    # The loss falls and every step's loss differs, with a gradient through
    # the final ReLU at every step (outputs that died would hold the loss).
    if not (loss_rel <= 1e-4 and worst[0] <= GRAD_TOL and moved_x <= KINK_X and shift <= 1e-3
            and not dead and enc_same
            and losses[-1] < losses[0] and len(set(losses)) == len(losses)
            and min(out_grad) > 0 and all(map(np.isfinite, losses))):
        raise AssertionError(f"fp32 train step: loss rel {loss_rel}, worst grad {worst}, kink "
                             f"sides moved at |x| {moved_x}, "
                             f"zero gradients {dead}, encoder same {enc_same}, losses {losses}, "
                             f"output gradients {out_grad}")
    if fp32_launches != TRAIN_STEP_LAUNCHES:
        raise AssertionError(f"fp32 train step launches {fp32_launches}")
    del cpu, gpu, gbatch

    # 3. The full-size step: vits, B 1, clip 20, 518^2, bf16 with fp32
    # masters, lstsq SSI + 10 TGM, lr 1e-4; 2 warm steps, the median of 5.
    rec = bts.measure("vits", 20, 518, 1, iters=5, warmup=2, fp32=False, device="cuda")
    state = rec.pop("state")
    print(f"train step vits 1x20x518x518 bf16 on {cardname}: {rec['value']:.2f} ms/step "
          f"(encoder {rec['split_ms']['encoder']:.2f}, head forward and loss "
          f"{rec['split_ms']['head']:.2f}, backward {rec['split_ms']['backward']:.2f}, optimizer "
          f"{rec['split_ms']['optimizer']:.2f} ms); K2 backward {rec['k2_backward_ms']:.3f} ms "
          f"per step ({100 * rec['k2_backward_share']:.1f} % of the step; its kernel alone "
          f"{2 * sum(per_shape[key]['ms'] for key in step_keys):.4f} ms, its bound "
          f"{2 * sum(per_shape[key]['bound_ms'] for key in step_keys):.4f} ms, the "
          f"exponentials alone {2 * sum(exps[key] for key in step_keys):.4f} ms); peak "
          f"{rec['peak_gib']:.2f} GiB; launches per step {rec['launches_per_step']}; losses "
          f"{', '.join(f'{x:.5f}' for x in rec['losses'])}; the last conv's largest weight "
          f"gradient {', '.join(f'{x:.2e}' for x in rec['output_grad_max'])}", flush=True)
    if not (rec["finite"] and len(set(rec["losses"])) == len(rec["losses"])
            and min(rec["output_grad_max"]) > 0
            and rec["launches_per_step"] == TRAIN_STEP_LAUNCHES):
        raise AssertionError(f"full-size train step: {rec}")

    # 4. A checkpoint on the card: the state saved and loaded into another;
    # the next step of each equal bit for bit (deterministic cuDNN).
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="vda_ckpt_")
    try:
        tcb = ts.TrainConfig(compute_dtype="bfloat16", clip_len=20)
        ckpt.save_checkpoint(tmp, "latest_checkpoint", state, {"epoch": 0, "trial": 0,
                                                              "best_val_loss": 1.0})
        other = ts.create_train_state(build_model(cfg, seed=1, device="cuda"), tcb)
        ckpt.load_checkpoint(tmp, "latest_checkpoint", template=other)
        data = bts.synthetic_batch(1, 20, 518, "cuda", seed=4)
        state, m1 = ts.train_step(state, data, cfg, tcb)
        other, m2 = ts.train_step(other, data, cfg, tcb)
        out_grad = state.head[bts.OUTPUT_WEIGHT].grad.abs().max().item()
        same = (float(m1["loss"]) == float(m2["loss"]) and state.step == other.step
                and all(torch.equal(a, b) for a, b in zip(state.head.values(), other.head.values()))
                and all(torch.equal(state.opt.state[a][key], other.opt.state[b][key])
                        for a, b in zip(state.head.values(), other.head.values())
                        for key in ("exp_avg", "exp_avg_sq", "step")))
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"checkpoint at step {state.step - 1} saved, loaded into another state: the next step "
          f"equal bit for bit (loss, head, Adam moments, step): {same}; its loss "
          f"{float(m1['loss']):.5f}, the last conv's largest weight gradient {out_grad:.2e}; "
          f"phase (n) {time.perf_counter() - t0:.1f} s", flush=True)
    if not (same and out_grad > 0 and float(m1["loss"]) not in rec["losses"]):
        raise AssertionError(f"checkpoint continuation: equal {same}, output gradient "
                             f"{out_grad}, loss {float(m1['loss'])} after {rec['losses']}")
    del state, other
    torch.cuda.empty_cache()
    # Per step: each of vits's four modules runs its two attention blocks.
    step = [per_shape[key] for key in step_keys]
    backward = {key: 2 * sum(e[key] for e in step)
                for key in ("ms", "plain_ms", "function_ms", "bound_ms", "library_ms")}
    backward.update(
        bound_by=sorted({e["bound_by"] for e in step})[0],
        shape=[[37 * 37, 20, 192], [19 * 19, 20, 384], [37 * 37, 20, 64], [74 * 74, 20, 64]],
        heads=8, dtype="bfloat16",
        library="F.scaled_dot_product_attention forward and backward, [P, 8, T, dh]",
        detail=dict(
            per_step="the four vits modules at T = 20, two calls each; ms: the kernel replayed "
                     "from a CUDA graph; function_ms: the Function's backward called back to "
                     "back (its host dispatch shows there); ms_in_step: events around it in "
                     "the step, where queued work hides that dispatch",
            function_ms=backward["function_ms"], ms_in_step=rec["k2_backward_ms"],
            share_of_step=rec["k2_backward_share"], per_shape=per_shape,
            max_rel_err=max(grad_err.values()), max_rel_err_bf16=grad_err["bfloat16"],
            max_rel_err_fp32=grad_err["float32"],
            reference="the plain version's autograd and the closed form in float64 "
                      "(k2_closed_form_grads), relative to each gradient's max |g|",
            vs_earlier_design=EARLIER_DESIGN,
            replaces="no TPU kernel: K2's pallas_call has no VJP; JAX's training takes XLA's "
                     "gradient of temporal_flat_attention"))
    return rec, backward


def distributed_path(cardname):
    """(o): the data-parallel path on the card, at world size 1 over NCCL
    (NCCL takes one card per rank, and the machine has one card): the
    mesh pipeline (bf16 and int8, windows_per_batch 2) and a distributed
    train step, each bit for bit with the same run without a mesh, with
    the kernels' launches read around the mesh calls. Returns the
    record and the mesh calls' launch counts."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import make_mesh
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline import infer
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.tools import bench_train_step as bts
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.utils.precision import synthetic_video

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    pdist.initialize(f"127.0.0.1:{port}", 1, 0)            # cuda: NCCL, nothing else
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group on {dist.get_backend()}, not NCCL")
    det = torch.backends.cudnn.deterministic
    tmp = tempfile.mkdtemp(prefix="vda_mesh_")
    try:
        mesh = make_mesh()
        cfg = get_model_config("vits")
        frames = synthetic_video(n=100, hw=(480, 640), seed=3)
        n, c = len(frames), 2
        chunks = -(-num_windows(n) // c)      # one encode and one head call per chunk
        rec, launches = {"windows_per_batch": c, "frames": n}, {}

        def wall(pipe, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, _ = pipe.infer_video_depth(frames, windows_per_batch=c, **kw)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t) / n

        # 1. bf16 serving: the mesh pipeline against the pipeline without one.
        plain = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
        on_mesh = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"), mesh=mesh)
        ref, _ = wall(plain)                                # warm-up
        kernels.reset_launch_counts()
        got, _ = wall(on_mesh)
        launches["bf16"] = kernels.launch_counts()
        same = np.array_equal(got, ref)
        ms = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            ms[which].append(wall(plain if which == "plain" else on_mesh)[1])
        wall(on_mesh, collect_timings=True)
        spans = on_mesh.timer.summary()
        gather, fwd = spans["all_gather"], spans["window_forward"]
        rec["bf16"] = {"equal_bit_for_bit": same, "ms_per_frame_plain": ms["plain"],
                       "ms_per_frame_mesh": ms["mesh"],
                       "all_gather_per_chunk_ms": gather["total_ms"] / fwd["count"],
                       "all_gather_calls": gather["count"], "chunks": fwd["count"],
                       "all_gather_share_of_window_forward": gather["total_ms"] / fwd["total_ms"]}
        print(f"mesh (NCCL, world 1) vits bf16, {n} frames 480x640 -> 518x686, C = {c}, on "
              f"{cardname}: equal bit for bit to no mesh: {same}; ms/frame no mesh "
              f"{', '.join(f'{x:.3f}' for x in ms['plain'])}, mesh "
              f"{', '.join(f'{x:.3f}' for x in ms['mesh'])}; all_gather {gather['count']} calls, "
              f"{rec['bf16']['all_gather_per_chunk_ms']:.4f} ms per chunk (CUDA events), "
              f"{100 * rec['bf16']['all_gather_share_of_window_forward']:.2f} % of the chunks' "
              f"window_forward time (the chunks' device intervals); launches {launches['bf16']}",
              flush=True)
        want = {name: 0 for name in launches["bf16"]}
        want.update(spatial_attention=cfg.vit.depth * chunks, temporal_attention=8 * chunks,
                    head_output_tail=chunks)
        if not (same and got.shape == frames.shape[:3] and launches["bf16"] == want):
            raise AssertionError(f"mesh bf16: equal {same}, launches {launches['bf16']}")
        del plain, on_mesh, ref, got

        # 2. int8: the mesh pipeline calibrates and writes the side file
        # (once); the pipeline without a mesh reads it.
        path = os.path.join(tmp, "vits.int8calib.npz")
        writes, save = [], infer._save_calib
        infer._save_calib = lambda *a: (writes.append(a[0]), save(*a))
        try:
            q_mesh = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"), mesh=mesh,
                                        quant="int8", calib_path=path)
            kernels.reset_launch_counts()
            got, _ = wall(q_mesh)
            launches["int8"] = kernels.launch_counts()
        finally:
            infer._save_calib = save
        q_plain = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"),
                                     quant="int8", calib_path=path)
        ref, _ = wall(q_plain)
        same = np.array_equal(got, ref)
        ms = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            ms[which].append(wall(q_plain if which == "plain" else q_mesh)[1])
        rec["int8"] = {"equal_bit_for_bit": same, "side_file_writes": len(writes),
                       "ms_per_frame_plain": ms["plain"], "ms_per_frame_mesh": ms["mesh"]}
        print(f"mesh int8: equal bit for bit to no mesh on the mesh's side file: {same}; side "
              f"file written {len(writes)} time(s); ms/frame no mesh "
              f"{', '.join(f'{x:.3f}' for x in ms['plain'])}, mesh "
              f"{', '.join(f'{x:.3f}' for x in ms['mesh'])}; launches {launches['int8']}",
              flush=True)
        want = {name: 0 for name in launches["int8"]}   # + one float calibration forward
        want.update(spatial_attention=cfg.vit.depth, temporal_attention=8 * (chunks + 1),
                    spatial_attention_qk8=cfg.vit.depth * chunks, head_output_tail=chunks + 1)
        if not (same and len(writes) == 1 and os.path.exists(path)
                and launches["int8"] == want):
            raise AssertionError(f"mesh int8: equal {same}, writes {writes}, "
                                 f"launches {launches['int8']}")
        del q_mesh, q_plain, ref, got
        torch.cuda.empty_cache()

        # 3. One distributed train step against the step without a mesh,
        # from the same state (tools/bench_train_step.py's weights and
        # clip, vits 1x20x518x518 bf16 with fp32 masters), three times.
        torch.backends.cudnn.deterministic = True
        cfg20 = get_model_config("vits", num_frames=20)
        tc = ts.TrainConfig(compute_dtype="bfloat16", clip_len=20)
        model = bts.synthetic_model(cfg20, 0, device="cuda")
        alone = ts.create_train_state(copy.deepcopy(model), tc)
        dp = ts.shard_train_state(ts.create_train_state(model, tc), mesh)
        batch = bts.synthetic_batch(1, 20, 518, "cuda", seed=3)
        step_ms = {"plain": [], "mesh": []}
        equal, losses = [], []
        for i in range(3):
            out = {}
            for which in ("plain", "mesh") if i % 2 == 0 else ("mesh", "plain"):
                if which == "mesh":
                    kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = ts.train_step(dp if which == "mesh" else alone, batch, cfg20, tc)
                torch.cuda.synchronize()
                step_ms[which].append(1e3 * (time.perf_counter() - t))
                out[which] = (float(m["loss"]), state)
                if which == "mesh":
                    launches["train"] = kernels.launch_counts()
            equal.append(out["plain"][0] == out["mesh"][0] and all(
                torch.equal(alone.head[k], dp.head[k]) for k in alone.head))
            losses.append(out["mesh"][0])
        rec["train"] = {"equal_bit_for_bit_per_step": equal, "losses": losses,
                        "ms_per_step_plain": step_ms["plain"], "ms_per_step_mesh": step_ms["mesh"],
                        "launches_per_step": {k: v for k, v in launches["train"].items() if v}}
        print(f"distributed train step (NCCL, world 1) vits 1x20x518x518 bf16: loss and every "
              f"head tensor equal bit for bit to the step without a mesh at each step: {equal}; "
              f"losses {', '.join(f'{x:.5f}' for x in losses)}; ms/step no mesh "
              f"{', '.join(f'{x:.2f}' for x in step_ms['plain'])}, mesh "
              f"{', '.join(f'{x:.2f}' for x in step_ms['mesh'])} (the first of each warms up); "
              f"launches per step {rec['train']['launches_per_step']}; phase (o) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not (all(equal) and len(set(losses)) == len(losses)
                and rec["train"]["launches_per_step"] == TRAIN_STEP_LAUNCHES):
            raise AssertionError(f"distributed train step: {rec['train']}")
        del alone, dp, model, state
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec, launches


# (p): the mesh's model axis on one card. NCCL takes one card per rank, so
# the two ranks are two processes on cuda:0 joined over gloo, whose
# broadcast / all_reduce / all_gather take CUDA tensors (through host
# memory). Their times are two processes sharing one card, never a cost of
# tensor parallelism across cards.
MODEL_AXIS_TIMEOUT_S = 600
MODEL_AXIS_FRAMES = 100
# A head trained three steps on the mesh against the head trained without:
# an entry is off when it differs by more than HEAD_TOL of its leaf's max
# |value| (floored at 1e-3 of the largest leaf's), phase (n)'s rule for
# gradients. At most the larger of HEAD_SHARE and twice the share that
# swap_halves moves without a mesh may be off. AdamW moves a weight by
# about the learning rate whatever the size of its gradient, so a
# near-zero gradient that changes sign under another sum order moves its
# weight by ~2 lr: ~3e-5 of vits' head in fp32, ~0.8 % in bf16, with or
# without a mesh (PERF.md §6). The split tensors are 55 % of the head's
# entries, and a fault in the split of their moments would move most of
# them.
HEAD_TOL = 1e-3
HEAD_SHARE = 1e-3


def head_errors(got: dict, ref: dict, lr: float) -> dict:
    """``got`` against ``ref`` by HEAD_TOL's rule: the share of entries
    off, and the three worst leaves as (max error over the leaf's max,
    leaf, max abs difference over the learning rate, entries off,
    entries)."""
    import numpy as np

    leaves = {k: v for k, v in ref.items() if v.dtype.kind == "f"}
    top = max(float(np.abs(v).max()) for v in leaves.values())
    rows = []
    for k, v in leaves.items():
        d = np.abs(got[k].astype(np.float64) - v)
        floor = max(float(np.abs(v).max()), 1e-3 * top)
        rows.append((float(d.max()) / floor, k, float(d.max()) / lr,
                     int((d > HEAD_TOL * floor).sum()), int(v.size)))
    rows.sort(reverse=True)
    return {"share_off": sum(r[3] for r in rows) / sum(r[4] for r in rows),
            "entries_off": sum(r[3] for r in rows), "worst": rows[:3]}


def swap_halves(model) -> None:
    """``model`` with the two halves of every unit a model axis of 2 splits
    (what ranks 0 and 1 hold: heads, MLP hidden units, GEGLU units) in the
    other order, in place. The same function in exact arithmetic, but
    every row-split product sums its contraction axis in another order:
    how far that moves an output is the floor of sum order, without a
    mesh. Applied twice, the model comes back bit for bit."""
    import torch
    from video_depth_anything_torch.parallel.mesh import _plan, merge_shards, shard_tensor

    sd = model.state_dict()
    with torch.no_grad():
        for keys in _plan(model, 2).values():
            for key, (dim, groups) in keys.items():
                t = sd[key]
                t.copy_(merge_shards([shard_tensor(t, dim, groups, 2, r) for r in (1, 0)],
                                     dim, groups))


def check_local_kernels(gen, record):
    """(p), the kernels at the model axis's local shapes (a model axis of
    2): K1 at vitl's 8 local heads [32, 1370, 512] and vits' 3 [22, 1814,
    192]; K3 at vitl's 8 (at vits' 3 it falls back to K1, (c')); K2 with 4
    local heads at vitl's motion modules (C/2 = 512 at dh 128, 128 at dh
    32) and vits' (96, 192, 32: dh 24, 48, 8), T = 32; bf16 and fp32, each
    against its plain version, bf16 timed beside its bound and SDPA.
    Returns {kernel: [entries]}."""
    import torch
    import torch.nn.functional as F
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
    from video_depth_anything_torch.kernels import temporal_attention as k2

    out = {"spatial_attention": [], "spatial_attention_qk8": [], "temporal_attention": []}
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        timed = name == "bfloat16"
        for label, b, s, h in (("vitl local", 32, 1370, 8), ("vits local", 22, 1814, 3)):
            c = h * 64
            qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            got = k1.spatial_attention(q, k, v, num_heads=h, scale=0.125)
            ref = k1.spatial_attention_plain(q, k, v, num_heads=h, scale=0.125)
            torch.cuda.synchronize()
            err, ok, said = held("spatial_attention", name, got, ref)
            line = f"(p) K1 {name:8s} {label} [{b},{s},{c}] H={h}: {said}"
            if not ok:
                raise AssertionError(line)
            record("spatial_attention", name, err)
            if timed:
                heads = [t.unflatten(-1, (h, 64)).transpose(1, 2) for t in (q, k, v)]
                e = dict(shape=[b, s, c], heads=h, dtype=name,
                         ms=time_ms(lambda: k1.spatial_attention(q, k, v, num_heads=h, scale=0.125), 20),
                         plain_ms=time_ms(lambda: k1.spatial_attention_plain(
                             q, k, v, num_heads=h, scale=0.125), 3, 1),
                         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                             *heads, scale=0.125), 20))
                e["bound_ms"], e["bound_by"] = bound_ms(4 * b * h * s * s * 64,
                                                        4 * b * s * c * q.element_size(), name)
                out["spatial_attention"].append(e)
                line += (f" kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.3f}, sdpa "
                         f"{e['library_ms']:.4f}, bound {e['bound_ms']:.4f} ({e['bound_by']})")
            print(line, flush=True)
            if h % 2 == 0:
                q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=gen,
                                        dtype=torch.int8) for _ in range(2))
                got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h)
                ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h)
                torch.cuda.synchronize()
                err, ok, said = held("spatial_attention_qk8", name, got, ref)
                line = f"(p) K3 {name:8s} {label} [{b},{s},{c}] H={h}: {said}"
                if not ok:
                    raise AssertionError(line)
                record("spatial_attention_qk8", name, err)
                if timed:
                    heads = [t.unflatten(-1, (h, 64)).transpose(1, 2) for t in
                             (q8.to(dt) * scales[0].to(dt), k8.to(dt) * scales[1].to(dt), v)]
                    e = dict(shape=[b, s, c], heads=h, dtype=name,
                             ms=time_ms(lambda: k3.spatial_attention_qk8(
                                 q8, k8, v, scales, num_heads=h), 20),
                             plain_ms=time_ms(lambda: k3.spatial_attention_qk8_plain(
                                 q8, k8, v, scales, num_heads=h), 3, 1),
                             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                                 *heads, scale=1.0), 20))
                    ops = 2 * b * h * s * s * 64
                    e["bound_ms"], e["bound_by"] = bound_ms(
                        ops * (1 + PEAK_OPS[name] / PEAK_OPS["int8"]),
                        b * s * c * (2 + 2 * v.element_size()), name)
                    out["spatial_attention_qk8"].append(e)
                    line += (f" kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.3f}, sdpa "
                             f"{e['library_ms']:.4f}, bound {e['bound_ms']:.4f} ({e['bound_by']})")
                print(line, flush=True)
                del q8, k8
            del qkv, q, k, v, got, ref
            torch.cuda.empty_cache()
        for label, p, c in (("vitl local 0", 37 * 37, 512), ("vitl local 1", 19 * 19, 512),
                            ("vitl local 2", 37 * 37, 128), ("vitl local 3", 74 * 74, 128),
                            ("vits local 0", 37 * 49, 96), ("vits local 1", 19 * 25, 192),
                            ("vits local 3", 74 * 98, 32)):
            h, t = 4, 32
            dh = c // h
            q, k, v = (torch.randn(p, t, c, device="cuda", generator=gen).to(dt) for _ in range(3))
            got = k2.temporal_attention(q, k, v, num_heads=h, scale=dh ** -0.5)
            ref = k2.temporal_attention_plain(q, k, v, num_heads=h, scale=dh ** -0.5)
            torch.cuda.synchronize()
            err, ok, said = held("temporal_attention", name, got, ref)
            line = f"(p) K2 {name:8s} {label} [{p},{t},{c}] H={h} dh={dh}: {said}"
            if not ok:
                raise AssertionError(line)
            record("temporal_attention", name, err)
            if timed:
                heads = [x.unflatten(-1, (h, dh)).transpose(1, 2) for x in (q, k, v)]
                e = dict(shape=[p, t, c], heads=h, dtype=name,
                         ms=graph_ms(lambda: k2.temporal_attention(
                             q, k, v, num_heads=h, scale=dh ** -0.5), 20),
                         plain_ms=time_ms(lambda: k2.temporal_attention_plain(
                             q, k, v, num_heads=h, scale=dh ** -0.5), 5, 1),
                         library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                             *heads, scale=dh ** -0.5), 20))
                e["bound_ms"], e["bound_by"] = bound_ms(4 * p * t * t * c,
                                                        4 * p * t * c * q.element_size(), name)
                out["temporal_attention"].append(e)
                line += (f" kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f}, sdpa "
                         f"{e['library_ms']:.4f}, bound {e['bound_ms']:.4f} ({e['bound_by']})")
            print(line, flush=True)
            del q, k, v, got, ref
    torch.cuda.empty_cache()
    return out


def gloo_cuda_check(mesh, rank: int) -> dict:
    """gloo's collectives on CUDA tensors, at (p)'s first call: broadcast,
    all_reduce SUM in fp32 / bf16 / int32 and MAX, and all_gather over the
    model group and over the data group of one rank, each checked; then
    the time of a 200 MB bf16 all_reduce over the model group (the size
    of one vitl encoder block's activations on 54 frames at 518x686)."""
    import torch
    import torch.distributed as dist

    model, data = mesh.get_group("model"), mesh.get_group("data")
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = torch.full((4,), rank + 1, dtype=dt, device="cuda")
        dist.all_reduce(x, group=model)
        if not bool((x == 3).all()):
            raise AssertionError(f"gloo all_reduce {dt} on CUDA: {x}")
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=model)
    y = torch.full((4,), float(rank + 1), device="cuda")
    dist.broadcast(y, src=dist.get_global_rank(model, 1), group=model)
    parts = [torch.empty(2, device="cuda") for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"), group=model)
    one = [torch.empty(2, device="cuda")]
    dist.all_gather(one, torch.full((2,), float(rank), device="cuda"), group=data)
    if not (bool((x == 2).all()) and bool((y == 2).all())
            and [p.tolist() for p in parts] == [[0.0, 0.0], [1.0, 1.0]]
            and one[0].tolist() == [float(rank)] * 2):
        raise AssertionError(f"gloo on CUDA: max {x}, broadcast {y}, all_gather {parts}, {one}")
    big = torch.ones(100_000_000, dtype=torch.bfloat16, device="cuda")
    dist.all_reduce(big, group=model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(big, group=model)
    torch.cuda.synchronize()
    return {"ops": "broadcast, all_reduce sum fp32/bf16/int32 and max, all_gather: ok",
            "all_reduce_200MB_bf16_s": (time.perf_counter() - t) / 3}


def model_axis_rank(rank: int, port: int, out: str) -> None:
    """One rank of (p) (``chip_smoke.py --model-axis-rank R PORT DIR``): a
    (1, 2) mesh over gloo on cuda:0; vitl at full width through the mesh
    pipeline (bf16 at windows_per_batch 2 on (e)'s video, the reduced clip
    in fp32, int8 calibrating and writing its side file), then three vits
    train steps in bf16 and three in fp32; the launch counts around each
    mesh call. Writes its depths, gathered heads and record under ``out``.
    Any failure raises."""
    import numpy as np
    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import gather_params, make_mesh
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.tools import bench_train_step as bts
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.utils.precision import synthetic_video

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda", backend="gloo")
    mesh = make_mesh(1, 2)
    rec = {"rank": rank, "launches": {}, "s": {}, "gloo": gloo_cuda_check(mesh, rank)}

    def timed(key, fn):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec["s"][key] = time.perf_counter() - t
        rec["launches"][key] = kernels.launch_counts()
        return res

    cfg = get_model_config("vitl")
    frames = synthetic_video(n=MODEL_AXIS_FRAMES, hw=(480, 640), seed=3)
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"), mesh=mesh)
    rec["local_heads"] = pipe.model.pretrained.blocks[0].attn.num_heads
    rec["local_motion_heads"] = pipe.model.head.motion_modules[0].temporal_transformer \
        .transformer_blocks[0].attention_blocks[0].num_heads
    d, _ = timed("bf16", lambda: pipe.infer_video_depth(frames, windows_per_batch=2))
    np.save(os.path.join(out, f"bf16_r{rank}.npy"), d)
    small = synthetic_video(n=40, hw=(140, 196), seed=5)
    d, _ = timed("fp32_reduced", lambda: pipe.infer_video_depth(
        small, input_size=112, fp32=True, windows_per_batch=2))
    np.save(os.path.join(out, f"fp32_r{rank}.npy"), d)
    del pipe
    torch.cuda.empty_cache()

    q = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"), mesh=mesh, quant="int8",
                           calib_path=os.path.join(out, "vitl.int8calib.npz"))
    d, _ = timed("int8", lambda: q.infer_video_depth(frames, windows_per_batch=2))
    np.save(os.path.join(out, f"int8_r{rank}.npy"), d)
    del q
    torch.cuda.empty_cache()

    cfg20 = get_model_config("vits", num_frames=20)
    batch = bts.synthetic_batch(1, 20, 518, "cuda", seed=3)
    for dtype, key in (("bfloat16", "train_step"), ("float32", "train_step_fp32")):
        tc = ts.TrainConfig(compute_dtype=dtype, clip_len=20)
        state = ts.shard_train_state(
            ts.create_train_state(bts.synthetic_model(cfg20, 0, device="cuda"), tc), mesh)
        rec[key + "_losses"], rec[key + "_s"] = [], []
        for _ in range(3):
            state, m = timed(key, lambda: ts.train_step(state, batch, cfg20, tc))
            rec[key + "_losses"].append(float(m["loss"]))
            rec[key + "_s"].append(rec["s"][key])
        head = {k: v.cpu().numpy() for k, v in gather_params(state.model, mesh).items()
                if k.startswith("head.")}
        np.savez(os.path.join(out, f"{key}_head_r{rank}.npz"), **head)
        del state
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def model_axis_path(cardname, gen, record):
    """(p): the model axis on the card. The kernels at their local shapes
    (``check_local_kernels``); then two ranks on cuda:0 over gloo
    (``model_axis_rank``), held against the same runs without a mesh in
    this process: vitl bf16 within the bf16 budget, the reduced clip in
    fp32 at rtol = atol = 2e-4, int8 on the ranks' side file within twice
    the flip floor, the ranks bit for bit with each other, K1 / K2 / K3
    launched at their local head counts; three vits train steps in bf16
    and in fp32, the ranks' losses and gathered heads bit for bit; the
    loss at every step within 5e-4 relative of the step without a mesh in
    fp32, and in bf16 within the larger of 5e-4 and bf16's own distance
    from fp32 at that step without a mesh; the head after three steps, in
    both dtypes, against the head trained without a mesh by HEAD_TOL, its
    share off within the larger of HEAD_SHARE and twice the sum-order
    floor's: the runs without a mesh against themselves with
    ``swap_halves`` (also reported for the drift and the losses). Returns (record, the mesh calls' launch counts, the local
    kernels' entries)."""
    import socket

    import numpy as np
    import torch
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.pipeline.windows import num_windows
    from video_depth_anything_torch.tools import bench_train_step as bts
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.utils.precision import (
        MAX_ERR_FRAC, MEAN_ERR_FRAC, flip_floor_report, precision_drift_report, synthetic_video)

    t0 = time.perf_counter()
    local = check_local_kernels(gen, record)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="vda_tp_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(2)]
        procs = []
        t_spawn = time.perf_counter()
        deadline = t_spawn + MODEL_AXIS_TIMEOUT_S
        try:
            for r in range(2):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), "--model-axis-rank", str(r),
                         str(port), tmp], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                        env=env))
            while any(p.poll() is None for p in procs) and time.perf_counter() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t_spawn
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(logs[r]) as f:
                    tail = f.read()[-6000:]
                raise AssertionError(f"(p) rank {r} exited {p.returncode}:\n{tail}")
        recs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        got = {key: [np.load(os.path.join(tmp, f"{key}_r{r}.npy")) for r in range(2)]
               for key in ("bf16", "fp32", "int8")}
        same = {key: bool(np.array_equal(*pair)) for key, pair in got.items()}
        for key in ("train_step", "train_step_fp32"):
            heads = [dict(np.load(os.path.join(tmp, f"{key}_head_r{r}.npz"))) for r in range(2)]
            same[key + "_losses"] = recs[0][key + "_losses"] == recs[1][key + "_losses"]
            same[key + "_heads"] = sorted(heads[0]) == sorted(heads[1]) and all(
                np.array_equal(heads[0][k], heads[1][k]) for k in heads[0])

        # The same runs without a mesh, in this process.
        cfg = get_model_config("vitl")
        frames = synthetic_video(n=MODEL_AXIS_FRAMES, hw=(480, 640), seed=3)
        model = build_model(cfg, seed=0, device="cuda")
        plain = VideoDepthPipeline(cfg, model)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref16, _ = plain.infer_video_depth(frames, windows_per_batch=2)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        small = synthetic_video(n=40, hw=(140, 196), seed=5)
        ref32, _ = plain.infer_video_depth(small, input_size=112, fp32=True, windows_per_batch=2)
        del plain
        side = os.path.join(tmp, "vitl.int8calib.npz")
        nudged = os.path.join(tmp, "nudged.npz")
        scale_side_file(side, nudged, 1 + 1e-6)
        ref8 = [VideoDepthPipeline(cfg, model, quant="int8", calib_path=path).infer_video_depth(
            frames, windows_per_batch=2)[0] for path in (side, nudged)]
        swap_halves(model)     # the sum-order floor: no mesh, halves swapped
        order16, _ = VideoDepthPipeline(cfg, model).infer_video_depth(frames, windows_per_batch=2)
        del model
        torch.cuda.empty_cache()
        cfg20 = get_model_config("vits", num_frames=20)
        batch = bts.synthetic_batch(1, 20, 518, "cuda", seed=3)
        ref_losses, loss_rel, head_err = {}, {}, {}
        order_rel, order_head = {}, {}
        for dtype, key in (("bfloat16", "train_step"), ("float32", "train_step_fp32")):
            tc = ts.TrainConfig(compute_dtype=dtype, clip_len=20)
            heads = []
            for swapped in (False, True):
                model = bts.synthetic_model(cfg20, 0, device="cuda")
                if swapped:
                    swap_halves(model)
                state = ts.create_train_state(model, tc)
                losses = []
                for _ in range(3):
                    state, m = ts.train_step(state, batch, cfg20, tc)
                    losses.append(float(m["loss"]))
                if swapped:
                    swap_halves(state.model)
                heads.append({k: v.cpu().numpy() for k, v in state.model.state_dict().items()
                              if k.startswith("head.")})
                if swapped:
                    order_rel[key] = [abs(a - b) / max(abs(b), 1.0)
                                      for a, b in zip(losses, ref_losses[key])]
                else:
                    ref_losses[key] = losses
                del state, model
                torch.cuda.empty_cache()
            loss_rel[key] = [abs(a - b) / max(abs(b), 1.0) for a, b in
                             zip(recs[0][key + "_losses"], ref_losses[key])]
            mesh_head = dict(np.load(os.path.join(tmp, f"{key}_head_r0.npz")))
            same[key + "_head_keys"] = sorted(mesh_head) == sorted(heads[0])
            head_err[key] = head_errors(mesh_head, heads[0], tc.learning_rate)
            order_head[key] = head_errors(heads[1], heads[0], tc.learning_rate)
        # bf16's own distance from fp32, per step, without a mesh: the budget
        # of a bf16 loss on the mesh where it exceeds 5e-4.
        bf16_budget = [max(5e-4, abs(a - b) / max(abs(b), 1.0)) for a, b in
                       zip(ref_losses["train_step"], ref_losses["train_step_fp32"])]

        drift = precision_drift_report(got["bf16"][0], ref16)
        order_drift = precision_drift_report(order16, ref16)
        f32_err = float(np.abs(got["fp32"][0] - ref32).max())
        f32_ok = bool(np.allclose(got["fp32"][0], ref32, rtol=2e-4, atol=2e-4))
        flip = flip_floor_report(got["int8"][0], ref8[0], ref8[1])
        same["int8_no_mesh"] = bool(np.array_equal(got["int8"][0], ref8[0]))
        n_chunks = -(-num_windows(MODEL_AXIS_FRAMES) // 2)
        launches = {k: recs[0]["launches"][k] for k in ("bf16", "int8", "train_step")}
        zeros = {name: 0 for name in launches["bf16"]}
        want = {"bf16": {**zeros, "spatial_attention": 24 * n_chunks,
                         "temporal_attention": 8 * n_chunks, "head_output_tail": n_chunks},
                "int8": {**zeros, "spatial_attention": 24, "spatial_attention_qk8": 24 * n_chunks,
                         "temporal_attention": 8 * (n_chunks + 1),
                         "head_output_tail": n_chunks + 1},
                "train_step": {**zeros, **TRAIN_STEP_LAUNCHES}}
        rec = {"mesh": [1, 2], "backend": "gloo, CUDA tensors, two processes on cuda:0",
               "gloo": recs[0]["gloo"],
               "local_heads": {"encoder": recs[0]["local_heads"],
                               "motion": recs[0]["local_motion_heads"]},
               "ranks_equal_bit_for_bit": same,
               "bf16_drift_vs_no_mesh": drift, "fp32_reduced_max_abs_err": f32_err,
               "int8_flip_floor": {"got": flip["got"], "limit": flip["limit"]},
               "train_losses_mesh": {k: recs[0][k + "_losses"] for k in ref_losses},
               "train_losses_no_mesh": ref_losses, "train_loss_rel_err": loss_rel,
               "train_loss_bf16_budget": bf16_budget, "head_after_3_steps": head_err,
               "sum_order_floor": {"bf16_drift": order_drift, "train_loss_rel_err": order_rel,
                                   "head_after_3_steps": order_head},
               "s_mesh_two_processes_one_card": recs[0]["s"],
               "train_s_mesh": {k: recs[0][k + "_s"] for k in ref_losses},
               "s_bf16_no_mesh": plain_s, "ranks_wall_s": ranks_s, "launches": launches}
        print(f"(p) gloo on CUDA tensors: {recs[0]['gloo']['ops']}; a 200 MB bf16 all_reduce "
              f"{recs[0]['gloo']['all_reduce_200MB_bf16_s']:.4f} s (two processes, one card)",
              flush=True)
        print(f"(p) model axis (1, 2), gloo with CUDA tensors, two processes on one {cardname}: "
              f"vitl {recs[0]['local_heads']} of 16 heads per rank, motion "
              f"{recs[0]['local_motion_heads']} of 8; ranks bit for bit {same}; bf16 against no "
              f"mesh: max {drift['max_err_frac']:.5f} / mean {drift['mean_err_frac']:.6f} "
              f"(budget {MAX_ERR_FRAC} / {MEAN_ERR_FRAC}); reduced clip fp32 max abs err "
              f"{f32_err:.3e} (rtol = atol = 2e-4); int8 {flip['got']['max_err_frac']:.5f} / "
              f"{flip['got']['mean_err_frac']:.6f} / rel L2 {flip['got']['rel_l2']:.3e} against "
              f"limits {flip['limit']}; train losses (bf16, fp32) {rec['train_losses_mesh']} "
              f"against {ref_losses} (rel {loss_rel}; tol fp32 5e-4, bf16 {bf16_budget}); "
              f"heads after three steps {head_err} (share off by > {HEAD_TOL} of the leaf's max "
              f"held to the larger of {HEAD_SHARE} and twice the floor's); sum-order floor (no mesh, halves swapped): bf16 drift "
              f"max {order_drift['max_err_frac']:.5f} / mean {order_drift['mean_err_frac']:.6f}, "
              f"losses rel {order_rel}, heads {order_head}; "
              f"launches per rank {launches}; wall s per call (two processes sharing the card) "
              f"{recs[0]['s']}, bf16 without a mesh {plain_s:.2f} s; ranks {ranks_s:.1f} s; "
              f"phase (p) {time.perf_counter() - t0:.1f} s", flush=True)
        if not (all(v for k, v in same.items() if k != "int8_no_mesh")
                and drift["max_err_frac"] < MAX_ERR_FRAC
                and drift["mean_err_frac"] < MEAN_ERR_FRAC and f32_ok and flip["ok"]
                and all(e <= b for e, b in zip(loss_rel["train_step"], bf16_budget))
                and max(loss_rel["train_step_fp32"]) < 5e-4
                and all(h["share_off"] <= max(HEAD_SHARE, 2 * order_head[k]["share_off"])
                        for k, h in head_err.items())
                and all(recs[0]["launches"][k] == want[k] for k in want)
                and recs[0]["local_heads"] == 8 and recs[0]["local_motion_heads"] == 4):
            raise AssertionError(f"(p) model axis: {rec}, launches wanted {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, launches, local


def artifact_refuses_missing_kernels() -> str:
    """(q): a vits artifact on the card whose kernel libraries cannot be
    loaded raises the build's error, as the live program does (no path
    around the kernels). Returns the error's first line."""
    import torch
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.utils import serving_export as se

    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0, device="cuda")
    run = se.artifact_module(se.export_window_program(cfg, (140, 196), input_size=112))
    win = torch.zeros((1, 32, 140, 196, 3), dtype=torch.uint8, device="cuda")
    state = se.cast_params(model.state_dict())
    with torch.no_grad():
        run(state, win)
        library = build.library

        def missing(name):
            raise build.KernelBuildError(f"{name}: library unavailable")

        build.library = missing
        try:
            run(state, win)
        except build.KernelBuildError as e:
            return str(e).splitlines()[0]
        finally:
            build.library = library
    raise AssertionError("(q) the artifact ran with its kernel libraries unavailable")


def serving_artifact_path(cardname):
    """(q): the serving artifact and the kernel build cache (module
    docstring); returns (the records, the launches per artifact call)."""
    import torch
    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.tools import bench_compile_cache
    from video_depth_anything_torch.tools import bench_serving_artifact as bsa

    t0 = time.perf_counter()
    recs, launches = {}, {}
    cases = (("vitl_bf16", dict(encoder="vitl"),
              {"spatial_attention": 24, "temporal_attention": 8, "head_output_tail": 1}),
             ("vits_int8", dict(encoder="vits", int8=True, cpu_trace=True),
              {"spatial_attention_qk8": 12, "temporal_attention": 8, "head_output_tail": 1}))
    for label, kw, want in cases:
        rec = bsa.measure(src_hw=(518, 518), iters=3, cpu_trace=kw.pop("cpu_trace", False), **kw)
        recs[label] = rec
        arts = [k for k in ("artifact", "artifact_cpu_traced") if k in rec]
        for k in arts:
            launches[f"{label}_{k}"] = rec[k]["launches_per_call"]
        summary = "; ".join(
            f"{k} (traced on {rec[k]['traced_on']}): equal {rec[k]['equal_to_live']}, "
            f"{rec[k]['ms_per_frame']:.3f} ms/frame (idle {rec[k]['idle_share']:.3f}), "
            f"export {rec[k]['export_s']:.1f} s, {rec[k]['bytes'] / 1e6:.2f} MB, "
            f"launches {rec[k]['launches_per_call']}" for k in arts)
        print(f"(q) {label} 518x518 C 1 on {cardname}: live {rec['live']['ms_per_frame']:.3f} "
              f"ms/frame (idle {rec['live']['idle_share']:.3f}), launches "
              f"{rec['live']['launches_per_call']}; {summary}", flush=True)
        ok = (rec["live"]["launches_per_call"] == want and rec["output_finite"]
              and rec["output_shape"] == [1, 32, 518, 518]
              and rec["int8_state_equal"] in (None, True)
              and all(rec[k]["equal_to_live"] and rec[k]["launches_equal_to_live"]
                      and rec[k]["vda_ops"] == want for k in arts))
        if not ok:
            raise AssertionError(f"(q) {label}: {rec}; launches and graph ops wanted {want}")
        torch.cuda.empty_cache()
    refused = artifact_refuses_missing_kernels()
    print(f"(q) no fallback: with its kernel library unavailable the artifact raises "
          f"({refused})", flush=True)
    recs["no_fallback"] = refused
    tmp = tempfile.mkdtemp(prefix="vda_kernel_cache_")
    try:
        cache = bench_compile_cache.measure(tmp, "vits", 518, timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    recs["compile_cache"] = cache
    print(f"(q) kernel build cache on {cardname}: cold {cache['cold_s']:.2f} s (build "
          f"{cache['cold']['build_s']:.2f} s, {cache['cold_nvcc_builds']} nvcc builds, first "
          f"window {cache['cold']['first_window_s']:.2f} s), warm {cache['warm_s']:.2f} s (build "
          f"{cache['warm']['build_s']:.3f} s, {cache['warm_nvcc_builds']} builds), speedup "
          f"{cache['speedup']:.2f}x; phase (q) {time.perf_counter() - t0:.1f} s", flush=True)
    if not (cache["cold_nvcc_builds"] == len(build.SOURCES) and cache["warm_nvcc_builds"] == 0
            and cache["cold"]["finite"] and cache["warm"]["finite"]):
        raise AssertionError(f"(q) compile cache: {cache}")
    return recs, launches


def stage_tools_path(cardname):
    """(r): the stage and measurement tools of tools/, once each at their
    full-width defaults with their timed repeats cut (module docstring).
    Returns (the records, each kernel's launches summed over the tools)."""
    import math

    import torch
    from video_depth_anything_torch import kernels
    from video_depth_anything_torch.tools import (
        bench_ablate, bench_attn_kernel, bench_drift_518, bench_head_convs, bench_head_fine,
        bench_int8_conv, bench_memory, bench_mxu_geometry, bench_residue, bench_segments,
        bench_stock_flash, bench_temporal_kernel, bench_temporal_swap, drift_split)
    from video_depth_anything_torch.utils.precision import MAX_ERR_FRAC, MEAN_ERR_FRAC

    t0 = time.perf_counter()
    total = {name: 0 for name in kernels.KERNELS}
    recs, walls = {}, {}

    def run(label, timed, fn):
        """fn's record, its launches read around it; every kernel the tool
        times must have launched."""
        t = time.perf_counter()
        kernels.reset_launch_counts()
        rec = fn()
        got = kernels.launch_counts()
        walls[label] = round(time.perf_counter() - t, 1)
        for name, n in got.items():
            total[name] += n
        missing = [name for name in timed if got[name] == 0]
        if missing:
            raise AssertionError(f"(r) {label}: no launch of {missing} ({got})")
        recs[label] = rec
        return rec

    _, model, x = bench_ablate.window("vitl")
    taps = []                   # the taps the forward hands its head
    hook = model.head.register_forward_pre_hook(lambda mod, args: taps.append(args[0]))
    try:
        with torch.no_grad():
            ref = model(x)      # VideoDepthAnything.forward, the reference of every check
    finally:
        hook.remove()
    taps = taps[0]
    for mode in bench_ablate.MODES:
        rec = run(f"ablate {mode}", bench_ablate.KERNELS_TIMED,
                  lambda mode=mode: bench_ablate.stage_deltas(model, x, mode, iters=1))
        if not (torch.equal(rec.pop("forward"), ref) and all(rec["restored"].values())):
            raise AssertionError(f"(r) ablate {mode}: the forward is not the model's, or a "
                                 f"stub was not restored: {rec['restored']}")
    rec = run("segments", bench_segments.KERNELS_TIMED,
              lambda: bench_segments.segments(model, x, iters=1))
    got_taps = rec.pop("taps")
    if not (torch.equal(rec.pop("forward"), ref)
            and all(torch.equal(a, b) and torch.equal(c, d)
                    for (a, c), (b, d) in zip(got_taps, taps))):
        raise AssertionError("(r) segments: its stages composed, or its taps, differ from "
                             "the model's forward")
    del got_taps, taps
    run("head_fine", bench_head_fine.KERNELS_TIMED,
        lambda: bench_head_fine.head_fine(model, iters=1))
    rec = run("temporal_swap", bench_temporal_swap.KERNELS_TIMED,
              lambda: bench_temporal_swap.swap(model, x, iters=1))
    if not (rec["restored"] and rec["sites"] == [2, 3]):
        raise AssertionError(f"(r) temporal_swap: {rec}")
    del model, x, ref
    torch.cuda.empty_cache()
    run("head_convs", bench_head_convs.KERNELS_TIMED, lambda: bench_head_convs.measure(iters=1))
    mem = []
    for enc in ("vits", "vitl"):
        for fp32 in (False, True):
            r = run(f"memory {enc} {'fp32' if fp32 else 'bf16'}", bench_memory.KERNELS_TIMED,
                    lambda enc=enc, fp32=fp32: bench_memory.measure(enc, 518, fp32))
            print(f"(r) memory {json.dumps(r)}", flush=True)
            if not (r["weights_plus_frames_bytes"] == r["accounted_bytes"]
                    and r["allocated_peak_bytes"] < r["card_bytes"] and r["output_finite"]):
                raise AssertionError(f"(r) memory: {r}")
            mem.append(r)
    rows = run("mxu_geometry", bench_mxu_geometry.KERNELS_TIMED,
               lambda: bench_mxu_geometry.rates(margin_s=PROBE_MARGIN_S))
    if any(r["over_peak"] for r in rows):
        raise AssertionError(f"(r) mxu_geometry: a rate over 105 % of its peak: {rows}")
    run("int8_conv", bench_int8_conv.KERNELS_TIMED, lambda: bench_int8_conv.measure(iters=1))
    run("residue", bench_residue.KERNELS_TIMED, lambda: bench_residue.measure(iters=2))
    torch.cuda.empty_cache()
    rec = run("drift_518", bench_drift_518.KERNELS_TIMED,
              lambda: dict(bench_drift_518.measure(frames=32, numpy_weights=0), card=cardname))
    print(f"(r) drift {json.dumps(rec)}", flush=True)
    numbers = [rec["frames"], *rec["src_hw"]] + [v for k, v in rec.items() if k.endswith("_frac")]
    limits = {"bf16": (MAX_ERR_FRAC, MEAN_ERR_FRAC), "int8": (VITL_INT8_MAX, VITL_INT8_MEAN)}
    over = [f"{mode} {k} {rec[f'{mode}_{k}_err_frac']} (limit {lim})"
            for mode, pair in limits.items() for k, lim in zip(("max", "mean"), pair)
            if not rec[f"{mode}_{k}_err_frac"] < lim]
    if not all(math.isfinite(v) for v in numbers) or over:
        raise AssertionError(f"(r) drift_518 over its limits: {over}; {rec}")
    if rec["weights_sha256"] != VITL_NUMPY_SHA256:
        raise AssertionError(f"(r) drift_518: numpy_state_dict(vitl, 0) drew other weights on "
                             f"this machine ({rec['weights_sha256']}); its limits were read on "
                             f"{VITL_NUMPY_SHA256}")
    # A reading, held to nothing but its weights and finite numbers: where
    # the bf16 drift on these weights comes from, encoder or head.
    rec = run("drift_split", drift_split.KERNELS_TIMED,
              lambda: drift_split.split("vitl", numpy_weights=0))
    print(f"(r) drift_split {json.dumps(rec)}", flush=True)
    numbers = [v for k in ("all_bf16", "encoder_bf16", "head_bf16") for v in rec[k].values()]
    if (rec["weights_sha256"] != VITL_NUMPY_SHA256
            or not all(math.isfinite(v) for v in numbers + sum(rec["tap_rel_l2"], []))):
        raise AssertionError(f"(r) drift_split: other weights or a number not finite: {rec}")
    torch.cuda.empty_cache()
    tol1 = TOL["spatial_attention"]["bfloat16"]
    rows = run("temporal_kernel", bench_temporal_kernel.KERNELS_TIMED,
               lambda: bench_temporal_kernel.compare(iters=1))
    bad = [r for r in rows if r["max_abs_err"] > TOL["temporal_attention"]["bfloat16"]]
    rec = run("stock_flash", bench_stock_flash.KERNELS_TIMED,
              lambda: bench_stock_flash.measure(iters=1))
    bad += [rec] if rec["max_abs_diff"] > tol1 else []
    rec = run("attn_kernel", bench_attn_kernel.KERNELS_TIMED["default"],
              lambda: bench_attn_kernel.variants(iters=1))
    # exp2 against base e is a change of function (log2 e rounded to bf16 in
    # q's scale): held to the plain versions' own difference, each variant to
    # its plain version.
    tol5 = TOL["spatial_attention_qkv_fused"]["bfloat16"]
    bad += [rec] if (max(rec["variant_diff"], *rec["variant_plain_err"].values()) > tol5
                     or abs(rec["exp2_diff"] - rec["exp2_plain_diff"]) > tol5) else []
    run("attn_kernel --int8", bench_attn_kernel.KERNELS_TIMED["int8"],
        lambda: bench_attn_kernel.int8(iters=1))
    if bad:
        raise AssertionError(f"(r) an agreement over its kernel's tolerance: {bad}")
    torch.cuda.empty_cache()
    print(f"(r) the stage tools on {cardname}: wall s per tool {walls}; launches {total}; "
          f"phase (r) {time.perf_counter() - t0:.1f} s", flush=True)
    return recs, total


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
    for enc in ("vits", "vitl", "vitg"):
        cfg = get_model_config(enc)
        model = build_model(cfg, seed=0, device="cuda").to(torch.bfloat16)
        x = torch.randn(1, INFER_LEN, 518, 518, 3, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        with torch.no_grad():
            for mode in ("bf16", "int8"):
                m = model if mode == "bf16" else _int8_model(model, x)
                iters = 3 if (mode == "int8" and enc == "vitl") or enc == "vitg" else 5
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


def breakdown(cardname, mode="bf16", encoder="vits"):
    """(f) continued: torch.profiler over one window forward of ``encoder``
    at 1x32x518x518 (bf16, or int8 with bf16 activations) — device time by
    kernel, by kind, and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model

    model = build_model(get_model_config(encoder), seed=0, device="cuda").to(torch.bfloat16)
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
    print(f"breakdown: {encoder} {mode} window forward 1x32x518x518 on {cardname}: wall "
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
    k7 = check_k7(record)
    torch.cuda.empty_cache()
    k8 = check_k8(gen, record)
    torch.cuda.empty_cache()
    probe_inputs, probe_plain = check_probes(record)
    probe_entries, launches_tools = probe_path(cardname, probe_inputs, probe_plain)
    del probe_inputs
    launches, d32 = main_path(cardname)
    launches_long, launches_long_int8, long_timings = long_video_path(cardname, d32)
    launches_int8 = int8_path(cardname, d32)
    launches_k4 = head_major_path(cardname)
    launches_k6 = rcu_cascade(cardname)
    launches_vitg, launches_vitg_int8, launches_vitg_cascade = vitg_path(cardname)
    variants_path(cardname)
    launches_metric = metric_path(cardname)
    train_rec, k2_backward = training_path(cardname, record)
    mesh_rec, launches_mesh = distributed_path(cardname)
    tp_rec, launches_tp, tp_local = model_axis_path(cardname, gen, record)
    serving_rec, launches_artifact = serving_artifact_path(cardname)
    tools_rec, launches_stage_tools = stage_tools_path(cardname)
    timing(cardname)
    breakdown(cardname)
    breakdown(cardname, "int8")
    breakdown(cardname, "bf16", "vitg")
    bench_record = bench_phase()

    # Each kernel's launches are counted on its own path: K1 and K2 on the
    # bf16 main path, K3 on the first int8 call, K4 on the head-dim-32
    # pipeline, K5 on its entry's own run, K6 on the vitl RefineNet cascade,
    # the K2 backward on the vits train step, K7 on the bf16 main path, K8 on
    # vitg's bf16 windows, T1-T3 on the bench tools' run. K7, K8 and T1-T3
    # are bf16 only (no fp32 error).
    bf16_only = ("phase_probes", "attention_variants", "qk_probes", "head_output_tail",
                 "swiglu")
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
        "temporal_attention_backward": dict(
            source="video_depth_anything_torch/csrc/temporal_attention_backward.cu",
            replaces="video_depth_anything_tpu/ops/attention.py:56", main=k2_backward,
            path=train_rec["launches_per_step"]),
        "fused_rcu": dict(
            source="video_depth_anything_torch/csrc/fused_rcu.cu",
            replaces="video_depth_anything_tpu/ops/pallas_conv.py:125", main=k6,
            path=launches_k6),
        "head_output_tail": dict(
            source="video_depth_anything_torch/csrc/head_output_tail.cu",
            replaces="none: XLA fuses video_depth_anything_tpu/models/dpt.py:151 output_head",
            main=k7, path=launches),
        "swiglu": dict(
            source="video_depth_anything_torch/csrc/swiglu.cu",
            replaces="none: XLA fuses video_depth_anything_tpu/models/dinov2.py:78 _ffn's gate",
            main=k8, path=launches_vitg),
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
            "launches_vitg_bf16": launches_vitg[name],
            "launches_vitg_int8": launches_vitg_int8[name],
            "launches_vitg_cascade": launches_vitg_cascade[name],
            "launches_metric_vitl": launches_metric[name],
            "launches_train_step": train_rec["launches_per_step"].get(name, 0),
            "launches_mesh_bf16": launches_mesh["bf16"][name],
            "launches_mesh_int8": launches_mesh["int8"][name],
            "launches_mesh_train_step": launches_mesh["train"][name],
            "launches_model_axis_bf16": launches_tp["bf16"][name],
            "launches_model_axis_int8": launches_tp["int8"][name],
            "launches_model_axis_train_step": launches_tp["train_step"][name],
            **{f"launches_{k}": n.get(name, 0) for k, n in launches_artifact.items()},
            "launches_bench_tools": launches_stage_tools[name],
            **({"model_axis_local_shapes": tp_local[name]} if name in tp_local else {}),
            "max_abs_err": max(errs[(name, "bfloat16")], fp32 or 0.0),
            "max_abs_err_bf16": errs[(name, "bfloat16")],
            "max_abs_err_fp32": fp32,
            "tolerance": TOL[name],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "shape": e["shape"], "heads": e.get("heads"), "dtype": e["dtype"],
            **{key: e[key] for key in ("library", "probes", "schedules", "derived", "ratio",
                                       "k1_ms", "k1_mxu_denom_ms", "switches_ms", "vitg",
                                       "vits")
               if key in e},
            **({"detail": e["detail"]} if "detail" in e else {}),
            **({"options_source": "video_depth_anything_torch/csrc/attention_switches.cu"}
               if name in ("spatial_attention", "attention_head_major",
                           "spatial_attention_qkv_fused") else {}),
        })
    print("long video, bench and train step summary: " + json.dumps(
        {"long_video": long_timings, "bench": bench_record, "train_step": train_rec,
         "distributed": mesh_rec, "model_axis": tp_rec, "serving_artifact": serving_rec,
         "stage_tools": tools_rec}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(cardname, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--model-axis-rank"]:     # one rank of (p), started by main
        model_axis_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
