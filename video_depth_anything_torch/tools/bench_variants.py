"""Card diagnosis of the wgmma kernels: build edited copies of their
sources and time each beside the shipped one.

    python -m video_depth_anything_torch.tools.bench_variants [rcu|attention|all]

Each variant is a list of text substitutions into a copy of ``csrc/``
(under ``_build/variants/``, gitignored), compiled with the build's own
flags and swapped in for the shipped library before timing. A variant that
removes work (products, loads) computes a wrong result on purpose: its
time says what the rest of the kernel costs, and its error is printed only
to show the substitution took. No variant removes a wait that a pipeline's
barrier phases depend on. Times are the mean of a run of launches between
CUDA events (``tools/timing.py``), bf16, at K6's largest vitl shape
(32, 148, 148, 256) and at K4's [32, 16, 1370, 64] and K1's main-path
[22, 1814, 384]. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from ..kernels import build
from .timing import card_line, time_ms

_WGMMA = ("wgmma_rs<NP, 0>(acc_a", "wgmma_rs<NP / 2, 0>(acc_b", "wgmma_rs<NP, 0>(acc, fa")

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
            ("attention_flash.cuh", "  named_sync(1 + wg, 256);\n  fence_regs(s);",
             "  fence_regs(s);"),
            ("attention_flash.cuh", "  if (wg == 0 || ntiles > 1) named_arrive(2 - wg, 256);\n",
             ""),
            ("attention_flash.cuh", "    named_sync(1 + wg, 256);       // this consumer's turn\n",
             ""),
            ("attention_flash.cuh", "    if (wg == 0 || t + 1 < ntiles) named_arrive(2 - wg, 256);"
             "   // the other's turn\n", "")]),
    },
}
_LIBS = {"fused_rcu": ("fused_rcu",), "both": ("attention_head_major", "spatial_attention")}


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


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("rcu", "attention", "all"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    build.build_all()
    shipped = dict(build._LIBS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for group, timer in (("rcu", _time_rcu), ("attention", _time_attention)):
        if which in (group, "all"):
            timer(_build_variants(group), gen)
            build._LIBS.update(shipped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
