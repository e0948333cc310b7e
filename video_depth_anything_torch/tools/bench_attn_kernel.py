"""A/B of the spatial attention kernels' variants on the card.

    python -m video_depth_anything_torch.tools.bench_attn_kernel [b] [s] [heads] [dh]
    python -m video_depth_anything_torch.tools.bench_attn_kernel --int8 [b] [s] [heads] [dh]

The port of the JAX package's ``tools/bench_attn_kernel.py``, at vitl's
518^2 shape (32 frames, 1370 tokens, 16 heads of 64), bf16, in one process.

Default: K5, the fused-qkv entry (``kernels/spatial_attention_qkv.py``), on
one [B, S, 3C] array with q pre-scaled, as shipped ("vpu denom"), with
``mxu_denom=True``, and with base-2 exponentials. K5 has no ``exp2``
switch (JAX has none there either), so that row is K1 with ``exp2=True``
and ``mxu_denom=True`` on the same three column views at scale 1, which is
what K5 launches. First, on the first two frames, the JAX tool's two
agreements (max |diff|): the two denominators, and exp2 against base e.
The second is no kernel error: exp2 multiplies q by log2(e) rounded to
bf16 (a 0.18 % change of every score), so it is printed beside the same
difference between the plain versions, and each variant is also held
against its own plain version (``variant_plain_err``). Then the times,
each variant twice, and the speed-ups over the better of each pair.

``--int8``: K3 (int8 QK, ``kernels/spatial_attention_qk8.py``) on random
int8 q, k (scales 0.02 dh^-0.5 and 0.02, the JAX tool's) and bf16 v,
against K1 with ``mxu_denom=True`` on bf16 q, k, v, and the speed-up.

Each time is the best of ITERS chains of CHAIN calls between CUDA events
(``timing.best_ms``). ``variants`` and ``int8`` are the measurements, for
chip_smoke.py too. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch

from ..kernels.spatial_attention import spatial_attention, spatial_attention_plain
from ..kernels.spatial_attention_qk8 import spatial_attention_qk8
from ..kernels.spatial_attention_qkv import spatial_attention_qkv_fused
from .timing import best_ms, bound_ms, card_line

B, S, H, DH = 32, 1370, 16, 64
CHAIN = 8
ITERS = 8
KERNELS_TIMED = {"default": ("spatial_attention_qkv_fused", "spatial_attention"),
                 "int8": ("spatial_attention_qk8", "spatial_attention")}


def fused_qkv(b: int, s: int, h: int, dh: int, gen: torch.Generator) -> torch.Tensor:
    """N(0, 1) [b, s, 3 h dh] in bf16, the q columns scaled by dh^-0.5."""
    c = h * dh
    qkv = torch.randn(b, s, 3 * c, device="cuda", generator=gen)
    qkv[..., :c] *= dh ** -0.5
    return qkv.to(torch.bfloat16)


def run_variant(qkv: torch.Tensor, num_heads: int, variant: str,
                plain: bool = False) -> torch.Tensor:
    """Variant "vpu", "mxu_denom" or "exp2" on the fused qkv; ``plain``:
    its plain version."""
    c = qkv.shape[-1] // 3
    if variant == "exp2" or plain:
        fn = spatial_attention_plain if plain else spatial_attention
        return fn(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], num_heads=num_heads,
                  scale=1.0, mxu_denom=variant != "vpu", exp2=variant == "exp2")
    return spatial_attention_qkv_fused(qkv, num_heads=num_heads,
                                       mxu_denom=variant == "mxu_denom")


def _timed(label, fn, flops, chain, iters) -> float:
    ms = best_ms(fn, chain, iters)
    print(f"  {label:24s} {ms:8.3f} ms/call  {flops / ms / 1e9:7.2f} TF/s", flush=True)
    return ms


@torch.no_grad()
def variants(b: int = B, s: int = S, h: int = H, dh: int = DH, iters: int = ITERS,
             chain: int = CHAIN, seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flops = 4 * b * h * s * s * dh
    bms, by = bound_ms(flops, 4 * b * s * h * dh * 2)
    print(f"packed attention, b={b} s={s} h={h} dh={dh}, chain={chain}, best of {iters}; "
          f"bound {bms:.4f} ms ({by})", flush=True)
    small = fused_qkv(2, s, h, dh, gen)
    names = ("vpu", "mxu_denom", "exp2")
    a, m, e = (run_variant(small, h, v).float() for v in names)
    pa, pm, pe = (run_variant(small, h, v, plain=True).float() for v in names)
    rec = dict(variant_diff=(a - m).abs().max().item(), exp2_diff=(m - e).abs().max().item(),
               exp2_plain_diff=(pm - pe).abs().max().item(),
               variant_plain_err={v: (k - p).abs().max().item()
                                  for v, k, p in zip(names, (a, m, e), (pa, pm, pe))},
               bound_ms=bms, bound_by=by, card=card_line())
    print(f"  variant agreement: max|diff| = {rec['variant_diff']:.2e}", flush=True)
    print(f"  exp2 agreement: max|diff| = {rec['exp2_diff']:.2e} (plain versions: "
          f"{rec['exp2_plain_diff']:.2e})", flush=True)
    print("  against the plain versions: " + ", ".join(
        f"{v} {err:.2e}" for v, err in rec["variant_plain_err"].items()), flush=True)
    qkv = fused_qkv(b, s, h, dh, gen)
    for key, label, v in (("vpu_ms", "vpu denom (old)", "vpu"),
                          ("mxu_ms", "mxu denom", "mxu_denom"),
                          ("exp2_ms", "mxu denom + exp2", "exp2"),
                          ("vpu_rerun_ms", "vpu denom (re-run)", "vpu"),
                          ("mxu_rerun_ms", "mxu denom (re-run)", "mxu_denom")):
        rec[key] = _timed(label, lambda v=v: run_variant(qkv, h, v), flops, chain, iters)
    vpu, mxu = min(rec["vpu_ms"], rec["vpu_rerun_ms"]), min(rec["mxu_ms"], rec["mxu_rerun_ms"])
    rec["mxu_denom_speedup"], rec["exp2_speedup"] = vpu / mxu, mxu / rec["exp2_ms"]
    print(f"  mxu-denom speedup: {rec['mxu_denom_speedup']:.3f}x", flush=True)
    print(f"  exp2 speedup: {rec['exp2_speedup']:.3f}x", flush=True)
    return rec


@torch.no_grad()
def int8(b: int = B, s: int = S, h: int = H, dh: int = DH, iters: int = ITERS,
         chain: int = CHAIN, seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = h * dh
    flops = 4 * b * h * s * s * dh
    print(f"packed attention, b={b} s={s} h={h} dh={dh}, chain={chain}, best of {iters}",
          flush=True)
    q, k, v = (torch.randn(b, s, c, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(2))
    scales = torch.tensor([0.02 * dh ** -0.5, 0.02], device="cuda")

    def bf16():
        return spatial_attention(q, k, v, num_heads=h, scale=dh ** -0.5, mxu_denom=True)

    rec = {"card": card_line(),
           "bf16_ms": _timed("bf16 QK (mxu denom)", bf16, flops, chain, iters),
           "int8_ms": _timed("int8 QK", lambda: spatial_attention_qk8(q8, k8, v, scales,
                                                                      num_heads=h),
                             flops, chain, iters),
           "bf16_rerun_ms": _timed("bf16 QK (re-run)", bf16, flops, chain, iters)}
    rec["int8_speedup"] = min(rec["bf16_ms"], rec["bf16_rerun_ms"]) / rec["int8_ms"]
    print(f"  int8-QK speedup: {rec['int8_speedup']:.3f}x", flush=True)
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quant = "--int8" in argv
    dims = [int(a) for a in argv if a != "--int8"][:4]
    dims += [B, S, H, DH][len(dims):]
    if not torch.cuda.is_available():
        print("bench_attn_kernel: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    (int8 if quant else variants)(*dims)
    return 0


if __name__ == "__main__":
    sys.exit(main())
