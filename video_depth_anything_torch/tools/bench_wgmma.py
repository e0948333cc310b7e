"""Card microbench of the redesigned kernels: K1, K3 (bf16 v), K4 and K5
(the attention body ``csrc/attention_flash.cuh``), K6
(``csrc/fused_rcu.cu``), K2 (``csrc/temporal_attention.cu``), the K2
backward (``csrc/temporal_attention_backward.cu``) and the measurement
kernels T1 (``csrc/phase_probes.cu``), T2
(``csrc/attention_variants.cu``) and T3 (``csrc/qk_probes.cu``) at the
shapes of PERF.md's kernel table,
each beside one PyTorch call of the same function (where there is one)
and its bound. K1 is also timed with ``mxu_denom=True`` at the main-path
and vitl shapes, where the tree's wrapper has the switch.

    python -m video_depth_anything_torch.tools.bench_wgmma [--label L] [--json PATH]
        [--k2_backward] [--compare DIR]

Imports are absolute and touch only the kernels' wrappers and the shared
timing module, so the same file times an older checkout of the package:
run it from that checkout's root as ``python /path/to/bench_wgmma.py``,
and the checkout's own kernels are built and timed. To compare two trees
on one card, run old, new, new, old in one session.

Per shape it prints (and writes as JSON lines) the kernel's ms (mean of a
run of launches between CUDA events, warm in L2 as far as the inputs fit
its 50 MB; K2's launches replayed from a CUDA graph, as they take less
card time than the host needs to launch them), the library call's ms (SDPA; K3: SDPA on q and k dequantized
to bf16; K2: SDPA on the split heads; the K2 backward: SDPA's forward and
backward on the split heads; K6: relu, cuDNN conv, relu, cuDNN conv, add),
the bound (the larger of the operations at their peak, bf16
989 TFLOP/s and K3's int8 QK at 1979 TOP/s, and the bytes at the HBM
rate) and the max abs error against the plain version. bf16 throughout.
``--k2_backward`` times the K2 backward's rows alone, each on inputs drawn
from a seed of its own, so that every tree and run sees the same inputs;
with ``--compare DIR`` the first run saves its dq / dk / dv in DIR and
every later run reports its max abs difference from them (old, new, new,
old: one tree's kernel against another's). Needs a CUDA card and exits 2
without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import torch
import torch.nn.functional as F

if __package__ in (None, ""):   # run by path: the package of the working directory
    sys.path.insert(0, os.getcwd())

from video_depth_anything_torch.tools.timing import (  # noqa: E402
    PEAK_OPS, bound_ms, card_line, exp_ms, time_ms)

ITERS = 20
K1_SHAPES = [("main 518x686 cached", 22, 1814, 6), ("vits 518^2", 32, 1370, 6),
             ("vitl 518^2", 32, 1370, 16)]
K4_SHAPES = [("dh 64", 32, 16, 1370, 64), ("dh 32", 32, 12, 1370, 32),
             ("dh 128 odd H", 16, 5, 1370, 128)]
K5_SHAPES = [("vits 518^2", 32, 1370, 6), ("vitl 518^2", 32, 1370, 16)]
K6_SHAPES = [(32, 148, 148, 256), (32, 74, 74, 256), (32, 37, 37, 256), (32, 19, 19, 256)]
K3_SHAPES = [("main 518x686 cached", 22, 1814, 6), ("vits 518^2", 32, 1370, 6),
             ("vitl 518^2", 32, 1370, 16)]
# (label, pixels per window, C) of motion modules 0..3, 8 heads, T = 32.
K2_FRAMES, K2_HEADS = 32, 8
K2_SHAPES = [(f"{enc} m{i}", p, c) for enc, mods in (
    ("vits 518^2", [(37 * 37, 192), (19 * 19, 384), (37 * 37, 64), (74 * 74, 64)]),
    ("vitl 518^2", [(37 * 37, 1024), (19 * 19, 1024), (37 * 37, 256), (74 * 74, 256)]),
    ("vits 518x686", [(37 * 49, 192), (19 * 25, 384), (37 * 49, 64), (74 * 98, 64)]))
    for i, (p, c) in enumerate(mods)]
# (label, P, T, C) of the K2 backward, 8 heads: the train step's vits
# motion modules 0..3 at its clip of 20 frames, vitl's dh 128 and dh 32
# modules at T = 32.
K2_BWD_HEADS = 8
K2_BWD_SHAPES = [("vits m0", 37 * 37, 20, 192), ("vits m1", 19 * 19, 20, 384),
                 ("vits m2", 37 * 37, 20, 64), ("vits m3", 74 * 74, 20, 64),
                 ("vitl m0 dh 128", 37 * 37, 32, 1024), ("vitl m2 dh 32", 37 * 37, 32, 256)]


# Here and not in tools/timing.py, so that this file times older trees too.
def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean ms per call over ``reps`` replays of a CUDA graph of ``iters``
    calls of ``fn``, after two calls outside it (builds, first use): for a
    call shorter than the host's cost of launching it through a wrapper
    (about 0.03 ms), time_ms would time the host, not the card."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def _row(kernel, label, shape, ms, lib, ops, nbytes, err):
    bms, by = bound_ms(ops, nbytes)
    return dict(kernel=kernel, label=label, shape=list(shape), ms=ms, library_ms=lib,
                bound_ms=bms, bound_by=by, max_abs_err=err)


@torch.no_grad()
def bench(gen: torch.Generator, compare: str | None = None) -> list[dict]:
    from video_depth_anything_torch.kernels import attention_head_major as k4
    from video_depth_anything_torch.kernels import fused_rcu as k6
    from video_depth_anything_torch.kernels import spatial_attention as k1
    from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
    from video_depth_anything_torch.kernels import spatial_attention_qkv as k5
    from video_depth_anything_torch.kernels import temporal_attention as k2
    from video_depth_anything_torch.tools import bench_rcu

    dt = torch.bfloat16
    rows = []
    for label, b, s, h in K1_SHAPES:
        c = h * 64
        qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        err = _err(k1.spatial_attention(q, k, v, num_heads=h, scale=0.125),
                   k1.spatial_attention_plain(q, k, v, num_heads=h, scale=0.125))
        ms = time_ms(lambda: k1.spatial_attention(q, k, v, num_heads=h, scale=0.125), ITERS)
        heads = [t.unflatten(-1, (h, 64)).transpose(1, 2) for t in (q, k, v)]
        lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=0.125), ITERS)
        rows.append(_row("K1", label, [b, s, c], ms, lib, 4 * b * h * s * s * 64, 8 * b * s * c, err))
        del qkv, q, k, v, heads
    for label, b, h, s, d in K4_SHAPES:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt) for _ in range(3))
        err = _err(k4.attention_head_major(q, k, v, scale=d ** -0.5),
                   k4.attention_head_major_plain(q, k, v, scale=d ** -0.5))
        ms = time_ms(lambda: k4.attention_head_major(q, k, v, scale=d ** -0.5), ITERS)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5), ITERS)
        rows.append(_row("K4", label, [b, h, s, d], ms, lib, 4 * b * h * s * s * d,
                         8 * b * h * s * d, err))
        del q, k, v
    for label, b, s, h in K5_SHAPES:
        c = h * 64
        qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)
        qkv[..., :c] *= 0.125
        err = _err(k5.spatial_attention_qkv_fused(qkv, num_heads=h),
                   k5.spatial_attention_qkv_fused_plain(qkv, num_heads=h))
        ms = time_ms(lambda: k5.spatial_attention_qkv_fused(qkv, num_heads=h), ITERS)
        heads = [t.unflatten(-1, (h, 64)).transpose(1, 2)
                 for t in (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])]
        lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), ITERS)
        rows.append(_row("K5", label, [b, s, 3 * c], ms, lib, 4 * b * h * s * s * 64,
                         8 * b * s * c, err))
        del qkv, heads
    for shape in K6_SHAPES:
        rcu = bench_rcu.random_unit(shape[3], gen)
        x = torch.randn(shape, device="cuda", generator=gen).to(dt)
        ops = rcu.kernel_operands(x.dtype)
        err = _err(k6.fused_rcu(x, *ops), k6.fused_rcu_plain(x, *ops))
        ms = time_ms(lambda: k6.fused_rcu(x, *ops), 10)
        lib = time_ms(lambda: rcu(x), 10)
        rows.append(_row("K6", f"{shape[1]}^2", shape, ms, lib, bench_rcu.flops(shape),
                         4 * x.numel(), err))
        del rcu, x, ops
    # K3 as chip_smoke.py (c') drives it: random int8 q, k, v a column view
    # of a fused qkv; its bound takes the int8 QK and the bf16 PV at their
    # own peaks, one after the other.
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    for label, b, s, h in K3_SHAPES:
        c = h * 64
        q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=gen,
                                dtype=torch.int8) for _ in range(2))
        v = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(dt)[..., 2 * c:]
        err = _err(k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h),
                   k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h))
        ms = time_ms(lambda: k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h), ITERS)
        heads = [t.unflatten(-1, (h, 64)).transpose(1, 2)
                 for t in (q8.to(dt) * scales[0].to(dt), k8.to(dt) * scales[1].to(dt), v)]
        lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), ITERS)
        ops = 2 * b * h * s * s * 64
        rows.append(_row("K3", label, [b, s, c], ms, lib,
                         ops * (1 + PEAK_OPS["bfloat16"] / PEAK_OPS["int8"]),
                         b * s * c * (2 + 2 * v.element_size()), err))
        del q8, k8, v, heads
    torch.cuda.empty_cache()
    rows += bench_k1_denominators(gen)
    torch.cuda.empty_cache()
    rows += bench_measurement(gen)
    torch.cuda.empty_cache()
    for label, p, c in K2_SHAPES:
        t, h = K2_FRAMES, K2_HEADS
        dh = c // h
        q, k, v = (torch.randn(p, t, c, device="cuda", generator=gen).to(dt) for _ in range(3))
        err = _err(k2.temporal_attention(q, k, v, num_heads=h, scale=dh ** -0.5),
                   k2.temporal_attention_plain(q, k, v, num_heads=h, scale=dh ** -0.5))
        # A CUDA graph of the calls: the smaller shapes take less card time
        # than the host needs to launch them.
        ms = graph_ms(lambda: k2.temporal_attention(q, k, v, num_heads=h, scale=dh ** -0.5), ITERS)
        heads = [x.unflatten(-1, (h, dh)).transpose(1, 2) for x in (q, k, v)]
        lib = graph_ms(lambda: F.scaled_dot_product_attention(*heads, scale=dh ** -0.5), ITERS)
        rows.append(_row("K2", label, [p, t, c], ms, lib, 4 * p * t * t * c,
                         4 * q.numel() * q.element_size(), err))
        del q, k, v, heads
    torch.cuda.empty_cache()
    return rows + bench_k2_backward(compare)


@torch.no_grad()
def bench_k2_backward(compare: str | None = None) -> list[dict]:
    """The K2 backward at K2_BWD_SHAPES: the kernel replayed from a CUDA
    graph, SDPA's forward and backward on the split heads, the bound (q,
    k, v, do read once, dq, dk, dv written once, against five T x T x dh
    products per (pixel, head)), the exponentials' own time, and the max
    abs error of dq / dk / dv against the plain version; with ``compare``,
    the max abs difference from the first run's outputs saved there."""
    from video_depth_anything_torch.kernels import temporal_attention as k2

    rows = []
    for i, (label, p, t, c) in enumerate(K2_BWD_SHAPES):
        h = K2_BWD_HEADS
        dh = c // h
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        q, k, v, do = (torch.randn(p, t, c, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))

        def run():
            return k2.temporal_attention_backward(q, k, v, do, num_heads=h, scale=dh ** -0.5)

        got = run()
        ref = k2.temporal_attention_backward_plain(q, k, v, do, num_heads=h, scale=dh ** -0.5)
        err = max(_err(g, r) for g, r in zip(got, ref))
        ms = graph_ms(run, ITERS)
        heads = [x.unflatten(-1, (h, dh)).transpose(1, 2).requires_grad_() for x in (q, k, v)]
        do_h = do.unflatten(-1, (h, dh)).transpose(1, 2)
        with torch.enable_grad():
            lib = time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, scale=dh ** -0.5), heads, do_h), ITERS)
        row = _row("K2 backward", label, [p, t, c], ms, lib, 10 * p * t * t * c,
                   7 * q.numel() * q.element_size(), err)
        row["exp_ms"] = exp_ms(p * h * t * t)
        if compare:
            path = os.path.join(compare, f"k2_backward_{i}.pt")
            if os.path.exists(path):
                first = torch.load(path)
                row["max_abs_diff_vs_first"] = max(_err(g, f.cuda()) for g, f in zip(got, first))
            else:
                os.makedirs(compare, exist_ok=True)
                torch.save([g.cpu() for g in got], path)
        rows.append(row)
        del q, k, v, do, got, ref, heads, do_h
    torch.cuda.empty_cache()
    return rows


# K1 with its denominator switch: the main path's cached window and vitl 518^2.
K1_DENOM_SHAPES = [("main 518x686 cached", 22, 1814, 6), ("vitl 518^2", 32, 1370, 16)]
# T1 at the phase bench's shapes: (probe, steps, rows, keys); T2 at its
# [B, S, H*64] with H = 16.
T1_SHAPES = [("qk64x2", 64, 1408, 1408), ("qk128", 64, 1408, 1408), ("qk+sm x2", 64, 1408, 1408),
             ("pv128x2", 24, 1408, 1408)]
T2_SHAPE = (32, 1370, 16)
T2_SCHEDULES = ("base", "stagger", "kchunk")
# T3 at bench_kernel_ab's shape: (probe, heads, steps, rows, keys).
T3_SHAPES = [("qk64 x2heads", 2, 64, 1408, 1408), ("qk128 x1", 1, 64, 1408, 1408)]


def bench_k1_denominators(gen: torch.Generator) -> list[dict]:
    """K1 with mxu_denom=True (beside the default rows of bench) where the
    wrapper takes it; none on a tree without the switch."""
    from video_depth_anything_torch.kernels import spatial_attention as k1

    if "mxu_denom" not in inspect.signature(k1.spatial_attention).parameters:
        print("K1 has no mxu_denom switch in this tree: no rows", flush=True)
        return []
    rows = []
    for label, b, s, h in K1_DENOM_SHAPES:
        c = h * 64
        qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]

        def run():
            return k1.spatial_attention(q, k, v, num_heads=h, scale=0.125, mxu_denom=True)

        err = _err(run(), k1.spatial_attention_plain(q, k, v, num_heads=h, scale=0.125,
                                                     mxu_denom=True))
        ms = time_ms(run, ITERS)
        heads = [x.unflatten(-1, (h, 64)).transpose(1, 2) for x in (q, k, v)]
        lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=0.125), ITERS)
        rows.append(_row("K1 mxu_denom", label, [b, s, c], ms, lib, 4 * b * h * s * s * 64,
                         8 * b * s * c, err))
        del qkv, q, k, v, heads
    return rows


def bench_measurement(gen: torch.Generator) -> list[dict]:
    """T1's four probes and T3's two (replayed from a CUDA graph: a probe
    takes about as long as the host needs to launch it) and T2's three
    schedules."""
    from video_depth_anything_torch.kernels import attention_variants as t2
    from video_depth_anything_torch.kernels import qk_probes as qp

    dt = torch.bfloat16
    rows = []
    for name, steps, m, n in T1_SHAPES:
        def uniform(*shape):
            return (torch.rand(shape, device="cuda", generator=gen) - 0.5).to(dt)

        if name == "pv128x2":
            args = (uniform(steps, m, n), uniform(steps, m, n), uniform(steps, n, 128))
            ref = qp.pv_plain(*args)
            ops, nbytes = 2 * 2 * steps * m * n * 128, steps * (2 * m * n + n * 128 + m * 128) * 2
        else:
            args = (uniform(steps, m, 128), uniform(steps, n, 128))
            ref = (qp.qk_softmax_plain(*args)[0] if name == "qk+sm x2"
                   else qp.qk_first128_plain(*args, heads=2 if name == "qk64x2" else 1))
            ops, nbytes = 2 * steps * m * n * 128, steps * (m + n + m) * 128 * 2
            if name == "qk+sm x2":
                nbytes += steps * m * 4   # the side sum
        err = _err(qp.phase_probe(name, *args), ref)
        ms = graph_ms(lambda: qp.phase_probe(name, *args), ITERS)
        rows.append(_row("T1", name, [steps, m, n], ms, None, ops, nbytes, err))
        del args, ref
    for name, heads, steps, m, n in T3_SHAPES:
        q, k = ((torch.rand(steps, r, 128, device="cuda", generator=gen) - 0.5).to(dt)
                for r in (m, n))
        err = _err(qp.qk_probe(q, k, heads=heads), qp.qk_colsum_plain(q, k, heads=heads))
        ms = graph_ms(lambda: qp.qk_probe(q, k, heads=heads), ITERS)
        # q and k in bf16 read once, the fp32 output written once.
        rows.append(_row("T3", name, [steps, m, n], ms, None, 2 * steps * m * n * 128,
                         steps * ((m + n) * 128 * 2 + m * 128 * 4), err))
        del q, k
    b, s, h = T2_SHAPE
    c = h * 64
    q, k, v = ((0.3 * torch.randn(b, s, c, device="cuda", generator=gen)).to(dt)
               for _ in range(3))
    ref = t2.attention_variant_plain(q, k, v, num_heads=h)
    heads = [x.unflatten(-1, (h, 64)).transpose(1, 2) for x in (q, k, v)]
    lib = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=0.125), ITERS)
    for sched in T2_SCHEDULES:
        def run():
            return t2.attention_variant(q, k, v, num_heads=h, schedule=sched)

        err = _err(run(), ref)
        rows.append(_row("T2", sched, [b, s, c], time_ms(run, ITERS), lib,
                         4 * b * h * s * s * 64, 8 * b * s * c, err))
    del q, k, v, ref, heads
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="", help="a name for this run in its output")
    parser.add_argument("--json", default=None, help="append the rows as JSON lines here")
    parser.add_argument("--k2_backward", action="store_true",
                        help="time only the K2 backward's rows")
    parser.add_argument("--compare", default=None,
                        help="save the K2 backward's outputs here, or compare with those saved")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_wgmma: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    rows = (bench_k2_backward(args.compare) if args.k2_backward
            else bench(torch.Generator(device="cuda").manual_seed(0), args.compare))
    for r in rows:
        r.update(run=args.label, card=card)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        extra = "".join(f", {key} {r[key]:.4g}" for key in ("exp_ms", "max_abs_diff_vs_first")
                        if key in r)
        print(f"[{args.label}] {r['kernel']} {r['label']:20s} {r['shape']}: kernel "
              f"{r['ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max abs err {r['max_abs_err']:.3e}{extra}", flush=True)
    step = [r for r in rows if r["kernel"] == "K2 backward" and r["label"].startswith("vits")]
    if step:   # each of the four modules' two attention blocks runs its backward once
        print(f"[{args.label}] K2 backward per vits train step (8 calls): "
              f"{2 * sum(r['ms'] for r in step):.4f} ms, bound "
              f"{2 * sum(r['bound_ms'] for r in step):.4f} ms, exponentials "
              f"{2 * sum(r['exp_ms'] for r in step):.4f} ms", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"[{args.label}] on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
