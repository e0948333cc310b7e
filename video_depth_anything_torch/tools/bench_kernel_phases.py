"""Card bench: K1's phases alone (T1) and K1's function under three
schedules (T2), at the vitl shape.

    python -m video_depth_anything_torch.tools.bench_kernel_phases [probes|variants|all]

The port of the JAX package's ``tools/bench_kernel_phases.py``, at its
shape: B = 32, S = 1370 (keys padded to 1408 in the probes), H = 16,
dh = 64, bf16.

``probes`` times the four T1 kernels (``kernels/qk_probes.py``, on the
attention body's wgmma + TMA machinery), each one phase of K1 per step of
1408 query rows: two 64-deep score tiles (qk64x2), one 128-deep (qk128),
two score tiles with their softmax sweeps (qk+sm x2) and two 1408-key PV
products (pv128x2); and qk64x2 once more with its sink, which stores the
sums of every key tile's scores: its time against the plain qk64x2 run
shows that no product was dropped. It prints µs per step, TF/s, each
probe's bound (the larger of its operations at the bf16 tensor-core peak
and its bytes at the HBM rate) and the exponentials' own time at the
special-function rate; then the derived softmax-only time, the phase sum
and the qk64 / qk128 ratio. Unlike the TPU's, these QK probes run every
product: the card's compiler cannot narrow them (``csrc/phase_probes.cu``).
The pv probe reads p and p2 from device memory, 190 MB over its 24 steps:
it is bytes-bound, where K1's PV keeps P in registers.

``variants`` times T2 (``kernels/attention_variants.py``, instances of
K1's body with the rounded-p denominator) under base, stagger and kchunk,
with its max abs error against K1 with either denominator on the same
inputs (stagger is K1's ``mxu_denom=True`` instance: 0 there), ms per
call, TF/s and µs per (batch, head pair); then K1 ("prod"), K1 with
``mxu_denom=True`` and PyTorch's scaled_dot_product_attention beside it.

Times are marginal ms per call from chains of launches
(``tools/timing.py``; the T1 chains replayed from CUDA graphs, as a probe
takes about as long as the host needs to launch it), warm in the 50 MB L2: a QK probe's q and k are
46 MB, T2's q, k, v 270 MB. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch

from .timing import (EXP_PER_S, HBM_BYTES_PER_S, PEAK_OPS, TARGET_MARGIN_S, bound_ms, card_line,
                     exp_ms, marginal_ms)

B, S, H, DH = 32, 1370, 16, 64
S_PAD = 1408
QK_STEPS, PV_STEPS = 64, 24


def probe_inputs() -> dict:
    """The tool's probe operands on the card, bf16, uniform in [-0.5, 0.5)
    from seed 0: "qk" (q, k) [64, 1408, 128] each; "pv" (p, p2 [24, 1408,
    1408], v [24, 1408, 128])."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform(*shape):
        return (torch.rand(shape, device="cuda", generator=gen) - 0.5).to(torch.bfloat16)

    return {"qk": (uniform(QK_STEPS, S_PAD, 2 * DH), uniform(QK_STEPS, S_PAD, 2 * DH)),
            "pv": (uniform(PV_STEPS, S_PAD, S_PAD), uniform(PV_STEPS, S_PAD, S_PAD),
                   uniform(PV_STEPS, S_PAD, 2 * DH))}


def probe_cost(name: str) -> dict:
    """Operations, bytes and exponentials of one call of a T1 probe at the
    tool's shape (the bf16 inputs read once, the output written once)."""
    qk_flops = QK_STEPS * 2 * S_PAD * S_PAD * 2 * DH      # both heads / the 128-deep tile
    qk_bytes = QK_STEPS * S_PAD * 2 * DH * 2 * 3          # q, k, bf16 output
    if name in ("qk64x2", "qk128"):
        return dict(flops=qk_flops, bytes=qk_bytes, exps=0, steps=QK_STEPS)
    if name == "qk+sm x2":
        return dict(flops=qk_flops, bytes=qk_bytes + QK_STEPS * S_PAD * 4,
                    exps=QK_STEPS * 2 * S_PAD * S_PAD, steps=QK_STEPS)
    if name == "pv128x2":
        return dict(flops=PV_STEPS * 2 * 2 * S_PAD * S_PAD * 2 * DH,
                    bytes=PV_STEPS * (2 * S_PAD * S_PAD + 2 * S_PAD * 2 * DH) * 2, exps=0,
                    steps=PV_STEPS)
    raise ValueError(name)


def probes(margin_s: float = TARGET_MARGIN_S, inputs: dict | None = None) -> dict:
    """Time the T1 probes (on ``inputs``, else ``probe_inputs()``); one dict
    per probe, also printed."""
    from ..kernels.qk_probes import phase_probe

    inputs = inputs or probe_inputs()
    rows = {}
    for row, name, sink in (("qk64x2", "qk64x2", False), ("qk128", "qk128", False),
                            ("qk+sm x2", "qk+sm x2", False), ("pv128x2", "pv128x2", False),
                            ("qk64x2 sink", "qk64x2", True)):
        args = inputs["pv" if name == "pv128x2" else "qk"]
        cost = probe_cost(name)
        ms = marginal_ms(lambda *a, n=name, k=sink: phase_probe(n, *a, sink=k), *args,
                         est_call_ms=cost["steps"] * 1e-3, margin_s=margin_s, graph=True)
        bms, by = bound_ms(cost["flops"], cost["bytes"])
        exps = exp_ms(cost["exps"])
        rows[row] = dict(ms=ms, us_per_step=ms / cost["steps"] * 1e3,
                         tflops=cost["flops"] / ms / 1e9, bound_ms=bms, bound_by=by,
                         exp_ms=exps, bytes_ms=cost["bytes"] / HBM_BYTES_PER_S * 1e3,
                         ops_ms=cost["flops"] / PEAK_OPS["bfloat16"] * 1e3)
        r = rows[row]
        print(f"{row:11s} {r['us_per_step']:7.2f} us/step  {r['tflops']:7.1f} TF/s  "
              f"{ms:.4f} ms/call, bound {bms:.4f} ms ({by}; operations {r['ops_ms']:.4f}, "
              f"bytes {r['bytes_ms']:.4f}" + (f"; exponentials alone {exps:.4f}" if exps else "")
              + ")", flush=True)
    t64, t128 = rows["qk64x2"]["us_per_step"], rows["qk128"]["us_per_step"]
    tsm, tpv = rows["qk+sm x2"]["us_per_step"], rows["pv128x2"]["us_per_step"]
    # qk+sm recomputes the scores of key tile 0 after its pass (1 of the 11
    # tiles of QK work) to take their exponentials against the final row max.
    extra = 1 / (S_PAD // 128) * t64
    exp_us = exp_ms(2 * S_PAD * S_PAD) * 1e3
    rows["derived"] = dict(softmax_us_per_step=tsm - t64,
                           softmax_less_recompute_us_per_step=tsm - t64 - extra,
                           phase_sum_us_per_step=tsm + tpv,
                           qk64_over_qk128=t64 / t128,
                           sink_over_plain=rows["qk64x2 sink"]["ms"] / rows["qk64x2"]["ms"])
    print(f"derived softmax-only: {tsm - t64:.2f} us/step (2 heads); {tsm - t64 - extra:.2f} "
          f"less the recomputed QK of 1 of 11 key tiles; the exponentials alone at "
          f"{EXP_PER_S / 1e12:.2f}e12/s: {exp_us:.2f} us/step")
    print(f"phase sum qk+sm+pv: {tsm + tpv:.2f} us/step vs kernel step from variants below")
    print(f"qk64 vs qk128 per useful flop: {t64 / t128:.2f}x (the same wgmma m64n128k16 "
          f"products, two chains of 4 against one of 8: 1.0 means depth 64 costs the card no "
          f"tensor-core rate); qk64x2 with its sink / without: "
          f"{rows['derived']['sink_over_plain']:.3f}", flush=True)
    return rows


def variant_inputs():
    """The tool's q, k, v: [32, 1370, 1024] bf16, N(0, 0.3^2) from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return tuple((0.3 * torch.randn(B, S, H * DH, device="cuda", generator=gen)).to(torch.bfloat16)
                 for _ in range(3))


def attention_cost() -> dict:
    """T2's (and K1's) work at the tool's shape: 4 B H S^2 dh operations,
    q, k, v read and o written once, B H S^2 exponentials."""
    return dict(flops=4 * B * H * S * S * DH, bytes=4 * B * S * H * DH * 2, exps=B * H * S * S)


def k1_and_sdpa(q, k, v, margin_s: float, width: int = 8) -> dict:
    """K1 as shipped ("prod"), K1 with ``mxu_denom=True`` ("prod mxu_denom")
    and PyTorch's scaled_dot_product_attention on the same [B, S, H*64]
    inputs; one dict per row, also printed."""
    import torch.nn.functional as F

    from ..kernels.spatial_attention import spatial_attention

    flops = attention_cost()["flops"]
    heads = [t.unflatten(-1, (H, DH)).transpose(1, 2) for t in (q, k, v)]
    rows = {}
    for name, fn, args in (
            ("prod", lambda q, k, v: spatial_attention(q, k, v, num_heads=H, scale=DH ** -0.5),
             (q, k, v)),
            ("prod mxu_denom", lambda q, k, v: spatial_attention(q, k, v, num_heads=H,
                                                                 scale=DH ** -0.5, mxu_denom=True),
             (q, k, v)),
            ("sdpa", lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=DH ** -0.5),
             heads)):
        ms = marginal_ms(fn, *args, est_call_ms=2.0, margin_s=margin_s)
        rows[name] = dict(ms=ms, tflops=flops / ms / 1e9)
        print(f"{name:{width}s} {ms:8.3f} ms/call  {rows[name]['tflops']:7.1f} TF/s", flush=True)
    return rows


def variants(margin_s: float = TARGET_MARGIN_S, inputs=None) -> dict:
    """Time T2 under each schedule (on ``inputs``, else
    ``variant_inputs()``), then K1 and SDPA; one dict per row, also
    printed."""
    from ..kernels.attention_variants import SCHEDULES, attention_variant
    from ..kernels.spatial_attention import spatial_attention

    q, k, v = inputs or variant_inputs()
    cost = attention_cost()
    bms, by = bound_ms(cost["flops"], cost["bytes"])
    exps = exp_ms(cost["exps"])
    print(f"bound {bms:.4f} ms ({by}); the exponentials alone {exps:.4f} ms", flush=True)
    ref = spatial_attention(q, k, v, num_heads=H, scale=DH ** -0.5).float()
    ref_mxu = spatial_attention(q, k, v, num_heads=H, scale=DH ** -0.5, mxu_denom=True).float()
    rows = {}
    for sched in SCHEDULES:
        got = attention_variant(q, k, v, num_heads=H, schedule=sched).float()
        err = (got - ref).abs().max().item()
        err_mxu = (got - ref_mxu).abs().max().item()
        ms = marginal_ms(lambda q, k, v, s=sched: attention_variant(q, k, v, num_heads=H,
                                                                    schedule=s),
                         q, k, v, est_call_ms=2.0, margin_s=margin_s)
        rows[sched] = dict(ms=ms, tflops=cost["flops"] / ms / 1e9, err_vs_k1=err,
                           err_vs_k1_mxu_denom=err_mxu,
                           us_per_head_pair=ms / (B * H // 2) * 1e3, bound_ms=bms, bound_by=by,
                           exp_ms=exps)
        print(f"{sched:8s} {ms:8.3f} ms/call  {rows[sched]['tflops']:7.1f} TF/s  "
              f"({rows[sched]['us_per_head_pair']:5.2f} us/step)  max|err| vs K1 {err:.2e}, "
              f"vs K1 mxu_denom {err_mxu:.2e}",
              flush=True)
    rows.update(k1_and_sdpa(q, k, v, margin_s, width=14))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "all"
    if mode not in ("probes", "variants", "all"):
        print(f"usage: bench_kernel_phases [probes|variants|all], not {mode!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_kernel_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; times warm in L2", flush=True)
    if mode in ("probes", "all"):
        probes()
    if mode in ("variants", "all"):
        variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
