"""Card bench: DCE-proof QK probes (T3), K1 as shipped, and the other
attention entry points at the vitl shape.

    python -m video_depth_anything_torch.tools.bench_kernel_ab [probes|variants|others|all]

The port of the JAX package's ``tools/bench_kernel_ab.py``, at its shape
(B = 32, S = 1370, H = 16, dh = 64, bf16).

``probes`` times T3 (``kernels/qk_probes.py::qk_probe``): the QK probes in
which every score column feeds the output (the output's column j sums the
scores of columns j, j + 128, ... over the heads), two 64-deep score tiles
per step (qk64) and one 128-deep tile (qk128). On the TPU the ratio of the
two read as the matrix unit's rate at depth 64. On this card both probes
run on wgmma m64n128k16 (``csrc/qk_probes.cu``), whose accumulators sum
the column groups themselves: per 64 rows and 128-key tile, qk64 issues
two chains of 4 k steps into two accumulators, qk128 one chain of 8 into
one. The same tensor-core work in both, so t(qk64 2-tile) / t(qk128
1-tile) is not a rate at depth 64: it weighs a second accumulator (its
registers, its sum in the epilogue) against one chain twice as long.

``variants`` times K1 as shipped ("prod"), K1 with ``mxu_denom=True``
and K1 with ``exp2=True`` (the JAX tool's "exp2" row: q pre-scaled in
bf16 by scale * log2(e), base-2 exponentials), with PyTorch's
scaled_dot_product_attention beside them. The JAX tool's "no-cost" rows
have no counterpart: they stripped ``cost_estimate``, an XLA scheduling
hint that a CUDA launch does not have.

``others`` times K5 (fused qkv), K3 (int8 QK) and K4 (head-major) at the
tool's shapes, as shipped, each with SDPA beside it.

Times are marginal ms per call from chains of launches
(``tools/timing.py``; the T3 chains replayed from CUDA graphs, as a probe
takes about as long as the host needs to launch it), warm in the 50 MB
L2. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch

from .bench_kernel_phases import (B, DH, H, QK_STEPS, S, S_PAD, attention_cost, k1_and_sdpa,
                                  probe_cost, probe_inputs, variant_inputs)
from .timing import HBM_BYTES_PER_S, TARGET_MARGIN_S, bound_ms, card_line, marginal_ms


def probes(margin_s: float = TARGET_MARGIN_S, inputs: dict | None = None) -> dict:
    """Time the T3 probes (the tool's q, k: those of T1's QK probes); one
    dict per probe, also printed."""
    from ..kernels.qk_probes import qk_probe

    q, k = (inputs or probe_inputs())["qk"]
    cost = probe_cost("qk64x2")
    nbytes = cost["bytes"] + QK_STEPS * S_PAD * 2 * DH * 2     # fp32 output
    rows = {}
    for name, heads in (("qk64 x2heads", 2), ("qk128 x1", 1)):
        ms = marginal_ms(lambda q, k, h=heads: qk_probe(q, k, heads=h), q, k,
                         est_call_ms=QK_STEPS * 1e-3, margin_s=margin_s, graph=True)
        bms, by = bound_ms(cost["flops"], nbytes)
        rows[name] = dict(ms=ms, us_per_step=ms / QK_STEPS * 1e3,
                          tflops=cost["flops"] / ms / 1e9, bound_ms=bms, bound_by=by,
                          bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(f"{name:14s} {rows[name]['us_per_step']:7.2f} us/step  "
              f"{rows[name]['tflops']:6.1f} TF/s  {ms:.4f} ms/call, bound {bms:.4f} ms ({by})",
              flush=True)
    ratio = rows["qk64 x2heads"]["ms"] / rows["qk128 x1"]["ms"]
    rows["ratio"] = ratio
    print(f"t(qk64 2-tile) / t(qk128 1-tile) = {ratio:.2f} (the same wgmma m64n128k16 work "
          f"in both: qk64's two 4-step chains into two accumulators against qk128's one "
          f"8-step chain)", flush=True)
    return rows


def variants(margin_s: float = TARGET_MARGIN_S, inputs=None) -> dict:
    """K1 as shipped, with mxu_denom, with exp2, and SDPA on the same
    inputs."""
    from ..kernels.spatial_attention import spatial_attention

    q, k, v = inputs or variant_inputs()
    rows = k1_and_sdpa(q, k, v, margin_s, width=14)
    ms = marginal_ms(lambda q, k, v: spatial_attention(q, k, v, num_heads=H, scale=DH ** -0.5,
                                                       exp2=True),
                     q, k, v, est_call_ms=2.0, margin_s=margin_s)
    rows["exp2"] = dict(ms=ms, tflops=attention_cost()["flops"] / ms / 1e9,
                        over_prod=ms / rows["prod"]["ms"])
    print(f"{'exp2':14s} {ms:8.3f} ms/call  {rows['exp2']['tflops']:7.1f} TF/s  "
          f"({rows['exp2']['over_prod']:.3f}x prod)", flush=True)
    print("no-cost: no counterpart on the card (cost_estimate is an XLA scheduling hint)",
          flush=True)
    return rows


def others(margin_s: float = TARGET_MARGIN_S) -> dict:
    """K5, K3 and K4 as shipped at the tool's shapes, each beside SDPA."""
    import torch.nn.functional as F

    from ..kernels.attention_head_major import attention_head_major
    from ..kernels.spatial_attention_qk8 import spatial_attention_qk8
    from ..kernels.spatial_attention_qkv import spatial_attention_qkv_fused

    gen = torch.Generator(device="cuda").manual_seed(0)
    c, scale = H * DH, DH ** -0.5
    flops = attention_cost()["flops"]

    def randn(*shape):
        return (0.3 * torch.randn(shape, device="cuda", generator=gen)).to(torch.bfloat16)

    def split(t):
        return t.unflatten(-1, (H, DH)).transpose(1, 2)

    qkv = randn(B, S, 3 * c)
    q8, k8 = (torch.randint(-127, 128, (B, S, c), device="cuda", generator=gen, dtype=torch.int8)
              for _ in range(2))
    v = randn(B, S, c)
    scales = torch.tensor([0.01, 0.01], device="cuda")
    q4, k4, v4 = randn(B, H, S, DH), randn(B, H, S, DH), randn(B, H, S, DH)
    deq = [split(t.to(torch.bfloat16) * 0.01) for t in (q8, k8)] + [split(v)]
    cases = (
        ("qkv_fused", lambda x: spatial_attention_qkv_fused(x, num_heads=H), (qkv,),
         lambda *t: F.scaled_dot_product_attention(*t, scale=1.0),
         [split(qkv[..., i * c:(i + 1) * c]) for i in range(3)]),
        ("qk8", lambda *a: spatial_attention_qk8(*a, num_heads=H), (q8, k8, v, scales),
         lambda *t: F.scaled_dot_product_attention(*t, scale=1.0), deq),
        ("plain", lambda *a: attention_head_major(*a, scale=scale), (q4, k4, v4),
         lambda *t: F.scaled_dot_product_attention(*t, scale=scale), [q4, k4, v4]),
    )
    rows = {}
    for name, fn, args, lib, lib_args in cases:
        ms = marginal_ms(fn, *args, est_call_ms=4.0, margin_s=margin_s)
        lib_ms = marginal_ms(lib, *lib_args, est_call_ms=4.0, margin_s=margin_s)
        rows[name] = dict(ms=ms, sdpa_ms=lib_ms, tflops=flops / ms / 1e9)
        print(f"{name:12s} shipped {ms:8.3f} ms  sdpa {lib_ms:8.3f} ms  "
              f"{rows[name]['tflops']:5.1f} TF/s", flush=True)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "all"
    if mode not in ("probes", "variants", "others", "all"):
        print(f"usage: bench_kernel_ab [probes|variants|others|all], not {mode!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; times warm in L2", flush=True)
    if mode in ("probes", "all"):
        probes()
    if mode in ("variants", "all"):
        variants()
    if mode in ("others", "all"):
        others()
    return 0


if __name__ == "__main__":
    sys.exit(main())
