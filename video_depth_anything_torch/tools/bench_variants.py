"""Card diagnosis of the wgmma kernels: build edited copies of their
sources and time each beside the shipped one.

    python -m video_depth_anything_torch.tools.bench_variants [rcu|attention|qk8|temporal|temporal_backward|qk|tail|all]

Each variant is a list of text substitutions into a copy of ``csrc/``
(under ``_build/variants/``, gitignored), compiled with the build's own
flags and swapped in for the shipped library before timing. A variant that
removes work (products, loads) computes a wrong result on purpose: its
time says what the rest of the kernel costs, and its error is printed only
to show the substitution took. No variant removes a wait that a pipeline's
barrier phases depend on. Times are the mean of a run of launches between
CUDA events (``tools/timing.py``; K2's replayed from a CUDA graph), bf16, at K6's largest vitl shape
(32, 148, 148, 256), at K4's [32, 16, 1370, 64] and K1's main-path
[22, 1814, 384], at K3's main-path [22, 1814, 384] and at K2's four
shapes of the main path, [7252, 32, 64], [1813, 32, 192], [475, 32, 384]
and [1813, 32, 64], at the K2 backward's six shapes (``bench_wgmma.py``'s
K2_BWD_SHAPES, replayed from a CUDA graph), and at T3's 64 steps of 1408
rows x 1408 keys (both probes, replayed from a CUDA graph), and K7 at the
vitl window's tail (C 128, N 32, 296x528 -> 518x924). Needs a CUDA card
and exits 2 without one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from ..kernels import build
from .bench_wgmma import graph_ms
from .timing import card_line, time_ms

_WGMMA = ("wgmma_rs<NP, 0>(acc_a", "wgmma_rs<NP / 2, 0>(acc_b", "wgmma_rs<NP, 0>(acc, fa")

_QK_NO_STORES = ("qk_probes.cu", "*reinterpret_cast<float2*>(orow + nb * 8) = v;",
                 "if (v.x == 0x1p40f) *reinterpret_cast<float2*>(orow + nb * 8) = v;")
_QK_NO_PRODUCTS = ("qk_probes.cu", "          wgmma_ss_n128<0, 0>(acc[h]",
                   "          if (a.M < 0) wgmma_ss_n128<0, 0>(acc[h]")

_TAIL_NO_PRODUCTS = ("head_output_tail.cu", "wgmma_rs<NOUT, 0>(acc[hr - dy],",
                     "if (0) wgmma_rs<NOUT, 0>(acc[hr - dy],")
_TAIL_NO_PASS1 = ("head_output_tail.cu", "i < G8 * sbw; i += UP", "i < 0; i += UP")
_TAIL_NO_PASS2 = [("head_output_tail.cu", "      rows_issue(acc[0], uwg);", ""),
                  ("head_output_tail.cu", "rows_issue(acc[(k + 1) & 1], uwg + 2 * (k + 1));", "")]

# name -> (library, [(file, old, new), ...])
VARIANTS = {
    "rcu": {
        "shipped": ("fused_rcu", []),
        "no products": ("fused_rcu", [("fused_rcu.cu", s, "if (0) " + s) for s in _WGMMA]),
        "no block-2 products": ("fused_rcu", [("fused_rcu.cu", _WGMMA[1], "if (0) " + _WGMMA[1])]),
        "no A loads": ("fused_rcu", [
            ("fused_rcu.cu", "ldsm_x4(ra4[ks]", "if (0) ldsm_x4(ra4[ks]"),
            ("fused_rcu.cu", "ldsm_x4(rb4[ks]", "if (0) ldsm_x4(rb4[ks]"),
            ("fused_rcu.cu", "ldsm_x4(r4[0], row);", ""),
            ("fused_rcu.cu", "ldsm_x4(r4[1], row + 32);", "")]),
        "cluster 1": ("fused_rcu", [("fused_rcu.cu", "constexpr int CS = 2;",
                                     "constexpr int CS = 1;")]),
        "cluster 4": ("fused_rcu", [("fused_rcu.cu", "constexpr int CS = 2;",
                                     "constexpr int CS = 4;")]),
        "remote arrive .release.cluster": ("fused_rcu", [
            ("hopper.cuh", "mbarrier.arrive.shared::cluster.b64",
             "mbarrier.arrive.release.cluster.shared::cluster.b64")]),
    },
    "attention": {
        "shipped": ("both", []),
        "no ping-pong": ("both", [
            ("attention_flash.cuh", "  if (wg == 1) named_arrive(1, 256);\n", ""),
            ("attention_flash.cuh",
             "    named_sync(1 + wg, 256);\n    fence_acc();\n    wgmma_fence();\n    issue_qk(0);",
             "    fence_acc();\n    wgmma_fence();\n    issue_qk(0);"),
            ("attention_flash.cuh", "  if (wg == 0 || ntiles > 1) named_arrive(2 - wg, 256);\n",
             ""),
            ("attention_flash.cuh", "    named_sync(1 + wg, 256);       // this consumer's turn\n",
             ""),
            ("attention_flash.cuh", "    if (wg == 0 || t + 1 < ntiles) named_arrive(2 - wg, 256);"
             "   // the other's turn\n", "")]),
    },
    "qk8": {
        "shipped": ("spatial_attention_qk8", []),
        "no exponentials": ("spatial_attention_qk8", [
            ("attention_flash.cuh", "s[4 * n + e] = fast_exp2(fmaf(s[4 * n + e], sl2, neg[e >> 1]));",
             "s[4 * n + e] = fmaf(s[4 * n + e], sl2, neg[e >> 1]);")]),
        "4 stages": ("spatial_attention_qk8", [
            ("attention_flash.cuh", "STAGES = DT == 128 ? 2 : 3;",
             "STAGES = DT == 128 ? 2 : (QK8 ? 4 : 3);")]),
        # Exact for |s| < 2^22: the bits of 1.5 * 2^23 plus s, less 1.5 * 2^23.
        "scores by float bits": ("spatial_attention_qk8", [
            ("attention_flash.cuh", "s[i] = static_cast<float>(static_cast<int>(si[i]));",
             "s[i] = __int_as_float(static_cast<int>(si[i]) + 0x4B400000) - 12582912.f;")]),
    },
    "temporal": {
        "shipped": ("temporal_attention", []),
        "no compute": ("temporal_attention", [
            ("temporal_attention.cu", "      if (g.split) head_attention<1>(",
             "      if (true) {} else if (g.split) head_attention<1>(")]),
        "no exponentials": ("temporal_attention", [
            ("temporal_attention.cu",
             "s[m][j][e] = fast_exp2(fmaf(s[m][j][e], LOG2E, neg[e >> 1]));",
             "s[m][j][e] = fmaf(s[m][j][e], LOG2E, neg[e >> 1]);")]),
        "stage 28 KB, 4 blocks": ("temporal_attention", [
            ("temporal_attention.cu", "STAGE_MAX = 14000;", "STAGE_MAX = 28000;"),
            ("temporal_attention.cu", "BLOCKS = 6;", "BLOCKS = 4;")]),
        "stage 20 KB, 5 blocks": ("temporal_attention", [
            ("temporal_attention.cu", "STAGE_MAX = 14000;", "STAGE_MAX = 20000;"),
            ("temporal_attention.cu", "BLOCKS = 6;", "BLOCKS = 5;")]),
    },
    "temporal_backward": {
        "shipped": ("temporal_attention_backward", []),
        # Frame columns padded to 2 MT blocks of 8 (32 at T 20), not ceil(T / 8),
        # each block masked past T.
        "columns 2 MT": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu", "const int nb = (T + 7) / 8;",
             "const int nb = 2 * mt;"),
            ("temporal_attention_backward.cu", "for (int j = NB - 1; j < NB; ++j)",
             "for (int j = 0; j < NB; ++j)")]),
        # Outputs written to the padded rows past T too, as zeros would be
        # (a fault: one unit's Inf reaches later units of its ring slot).
        "no row guard": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu", "if (mb + 1 < MT || row < T)", "if (true)")]),
        # A ring of one tile: no load in flight while a tile computes.
        "ring 1": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu",
             "g.ring = 2 * g.U * g.unit_bytes <= BLOCK_SMEM ? 2 : 1;", "g.ring = 1;")]),
        # vits's dh 8 and 24 at a width read at run time, as every other dh.
        "runtime widths": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu", "case 8: return launch_nb<1>(",
             "case 8: return launch_nb<0>("),
            ("temporal_attention_backward.cu", "case 24: return launch_nb<3>(",
             "case 24: return launch_nb<0>(")]),
        "dh 8 at 4 blocks": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu", "BLOCKS_DH8 = 5;", "BLOCKS_DH8 = 4;")]),
        "dh 8 at 6 blocks": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu", "BLOCKS_DH8 = 5;", "BLOCKS_DH8 = 6;")]),
        # The softmax's exponentials as plain multiplies (a wrong result).
        "no exponentials": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu",
             "s[m][j][e] = fast_exp2(fmaf(s[m][j][e], LOG2E, neg[e >> 1]));",
             "s[m][j][e] = fmaf(s[m][j][e], LOG2E, neg[e >> 1]);")]),
        # Loads, stores and barriers as shipped, no item computed (a wrong result).
        "no compute": ("temporal_attention_backward", [
            ("temporal_attention_backward.cu",
             "      item_bf16<MT, NB, NN>(b,", "      if (g.T < 0) item_bf16<MT, NB, NN>(b,")]),
    },
    "qk": {
        "shipped": ("qk_probes", []),
        # The same kernel with a block per tile: each block walks one tile.
        "one block per tile": ("qk_probes", [
            ("qk_probes.cu", "a.tiles < sms ? a.tiles : sms", "a.tiles")]),
        "5 K stages": ("qk_probes", [("qk_probes.cu", "K_ST = 4;", "K_ST = 5;")]),
        # The sums are computed but stored only if one is exactly 2^40 (none is).
        "no stores": ("qk_probes", [_QK_NO_STORES]),
        # Every wait and release as shipped, no product issued: loads and stores.
        "no products": ("qk_probes", [_QK_NO_PRODUCTS]),
        "loads only": ("qk_probes", [_QK_NO_PRODUCTS, _QK_NO_STORES]),
    },
    "tail": {
        "shipped": ("head_output_tail", []),
        "no products": ("head_output_tail", [_TAIL_NO_PRODUCTS]),
        "no row pass": ("head_output_tail", [_TAIL_NO_PASS1]),
        "no column pass": ("head_output_tail", _TAIL_NO_PASS2),
        "no upsample": ("head_output_tail", [_TAIL_NO_PASS1, *_TAIL_NO_PASS2]),
        "loads and stores only": ("head_output_tail", [_TAIL_NO_PASS1, *_TAIL_NO_PASS2,
                                                       _TAIL_NO_PRODUCTS]),
    },
}
_LIBS = {"fused_rcu": ("fused_rcu",), "both": ("attention_head_major", "spatial_attention"),
         "spatial_attention_qk8": ("spatial_attention_qk8",),
         "temporal_attention": ("temporal_attention",), "qk_probes": ("qk_probes",),
         "temporal_attention_backward": ("temporal_attention_backward",),
         "head_output_tail": ("head_output_tail",)}


def _build_variants(group: str) -> dict[str, dict[str, str]]:
    """Compile every variant of the group in parallel; name -> {lib: path}."""
    root = os.path.join(build.BUILD_DIR, "variants", group)
    procs = []
    for name, (libs, subs) in VARIANTS[group].items():
        d = os.path.join(root, name.replace(" ", "_").replace(".", ""))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in subs:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for lib in _LIBS[libs]:
            out = os.path.join(d, f"lib{lib}.so")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out, os.path.join(d, lib + ".cu")]
            procs.append((name, lib, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built: dict[str, dict[str, str]] = {}
    for name, lib, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"variant {name!r} ({lib}):\n{log[-3000:]}")
        built.setdefault(name, {})[lib] = out
    return built


@torch.no_grad()
def _time_rcu(built, gen):
    from ..kernels import fused_rcu as k6
    from . import bench_rcu

    shape = (32, 148, 148, 256)
    rcu = bench_rcu.random_unit(shape[3], gen)
    x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    ops = rcu.kernel_operands(x.dtype)
    ref = k6.fused_rcu_plain(x, *ops)
    for name, libs in built.items():
        build._LIBS["fused_rcu"] = ctypes.CDLL(libs["fused_rcu"])
        err = (k6.fused_rcu(x, *ops).float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: k6.fused_rcu(x, *ops), 10)
        print(f"K6 {shape} {name:32s} {ms:.4f} ms (max abs err {err:.3e})", flush=True)


@torch.no_grad()
def _time_attention(built, gen):
    from ..kernels import attention_head_major as k4
    from ..kernels import spatial_attention as k1

    q, k, v = (torch.randn(32, 16, 1370, 64, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    qkv = torch.randn(22, 1814, 3 * 384, device="cuda", generator=gen).to(torch.bfloat16)
    a, b, c = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]
    for rep in range(2):
        for name, libs in built.items():
            for lib, path in libs.items():
                build._LIBS[lib] = ctypes.CDLL(path)
            t4 = time_ms(lambda: k4.attention_head_major(q, k, v, scale=0.125), 30)
            t1 = time_ms(lambda: k1.spatial_attention(a, b, c, num_heads=6, scale=0.125), 30)
            print(f"attention {name:14s} (round {rep + 1}): K4 [32, 16, 1370, 64] {t4:.4f} ms, "
                  f"K1 [22, 1814, 384] {t1:.4f} ms", flush=True)


@torch.no_grad()
def _time_qk8(built, gen):
    from ..kernels import spatial_attention_qk8 as k3

    q8, k8 = (torch.randint(-127, 128, (22, 1814, 384), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(2))
    v = torch.randn(22, 1814, 3 * 384, device="cuda", generator=gen).to(torch.bfloat16)[..., 768:]
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=6)
    for rep in range(2):
        for name, libs in built.items():
            build._LIBS["spatial_attention_qk8"] = ctypes.CDLL(libs["spatial_attention_qk8"])
            err = (k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=6).float()
                   - ref.float()).abs().max().item()
            ms = time_ms(lambda: k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=6), 30)
            print(f"K3 [22, 1814, 384] {name:16s} (round {rep + 1}) {ms:.4f} ms "
                  f"(max abs err {err:.3e})", flush=True)


@torch.no_grad()
def _time_temporal(built, gen):
    from ..kernels import temporal_attention as k2

    cases = []
    for p, c in ((7252, 64), (1813, 192), (475, 384), (1813, 64)):
        q, k, v = (torch.randn(p, 32, c, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        dh = c // 8
        cases.append((q, k, v, dh, k2.temporal_attention_plain(q, k, v, num_heads=8,
                                                                scale=dh ** -0.5)))
    for rep in range(2):
        for name, libs in built.items():
            build._LIBS["temporal_attention"] = ctypes.CDLL(libs["temporal_attention"])
            line = []
            for q, k, v, dh, ref in cases:
                err = (k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5).float()
                       - ref.float()).abs().max().item()
                ms = graph_ms(lambda: k2.temporal_attention(q, k, v, num_heads=8,
                                                            scale=dh ** -0.5), 30)
                line.append(f"{list(q.shape)} {ms:.4f} ms (err {err:.1e})")
            print(f"K2 {name:16s} (round {rep + 1}): " + ", ".join(line), flush=True)


@torch.no_grad()
def _time_temporal_backward(built, gen):
    from ..kernels import temporal_attention as k2
    from .bench_wgmma import K2_BWD_HEADS, K2_BWD_SHAPES

    h, cases = K2_BWD_HEADS, []
    for _, p, t, c in K2_BWD_SHAPES:
        x = [torch.randn(p, t, c, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(4)]
        dh = c // h
        cases.append((x, dh, k2.temporal_attention_backward_plain(*x, num_heads=h,
                                                                  scale=dh ** -0.5)))
    for rep in range(2):
        for name, libs in built.items():
            build._LIBS["temporal_attention_backward"] = ctypes.CDLL(
                libs["temporal_attention_backward"])
            line = []
            for x, dh, ref in cases:
                def run():
                    return k2.temporal_attention_backward(*x, num_heads=h, scale=dh ** -0.5)

                err = max((g.float() - r.float()).abs().max().item()
                          for g, r in zip(run(), ref))
                line.append(f"{list(x[0].shape)} {graph_ms(run, 30):.4f} ms (err {err:.1e})")
            print(f"K2 backward {name:22s} (round {rep + 1}): " + ", ".join(line), flush=True)


@torch.no_grad()
def _time_qk(built, gen):
    from ..kernels import qk_probes as qp

    q, k = ((torch.rand(64, 1408, 128, device="cuda", generator=gen) - 0.5).to(torch.bfloat16)
            for _ in range(2))
    refs = {h: qp.qk_colsum_plain(q, k, heads=h) for h in (2, 1)}
    for rep in range(2):
        for name, libs in built.items():
            build._LIBS["qk_probes"] = ctypes.CDLL(libs["qk_probes"])
            line = []
            for heads, ref in refs.items():
                err = (qp.qk_probe(q, k, heads=heads) - ref).abs().max().item()
                ms = graph_ms(lambda: qp.qk_probe(q, k, heads=heads), 30)
                line.append(f"heads {heads} {ms:.4f} ms (err {err:.1e})")
            print(f"T3 [64, 1408, 1408] {name:18s} (round {rep + 1}): " + ", ".join(line),
                  flush=True)


@torch.no_grad()
def _time_tail(built, gen):
    from ..kernels import head_output_tail as k7

    x = torch.randn(32, 296, 528, 128, device="cuda", generator=gen).to(torch.bfloat16)
    ops = (torch.randn(32, 128, 3, 3, device="cuda", generator=gen) * 0.03,
           0.1 * torch.randn(32, device="cuda", generator=gen),
           torch.randn(1, 32, 1, 1, device="cuda", generator=gen) * 0.18,
           0.1 * torch.randn(1, device="cuda", generator=gen))
    ops = tuple(t.to(torch.bfloat16) for t in ops)
    ref = k7.head_output_tail_plain(x, *ops, (518, 924))
    for rep in range(2):
        for name, libs in built.items():
            build._LIBS["head_output_tail"] = ctypes.CDLL(libs["head_output_tail"])
            err = (k7.head_output_tail(x, *ops, (518, 924)) - ref).abs().max().item()
            ms = time_ms(lambda: k7.head_output_tail(x, *ops, (518, 924)), 10)
            print(f"K7 [32, 296, 528, 128] {name:22s} (round {rep + 1}) {ms:.4f} ms "
                  f"(max abs err {err:.3e})", flush=True)


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in (*VARIANTS, "all"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    build.build_all()
    shipped = dict(build._LIBS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for group, timer in (("rcu", _time_rcu), ("attention", _time_attention), ("qk8", _time_qk8),
                         ("temporal", _time_temporal),
                         ("temporal_backward", _time_temporal_backward), ("qk", _time_qk),
                         ("tail", _time_tail)):
        if which in (group, "all"):
            timer(_build_variants(group), gen)
            build._LIBS.update(shipped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
