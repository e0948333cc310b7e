"""K1 against PyTorch's own flash attention, with the layout the model would
pay to call it, on the card.

    python -m video_depth_anything_torch.tools.bench_stock_flash [b] [s] [heads] [dh]

The port of the JAX package's ``tools/bench_stock_flash.py``. The model's
spatial attention at 518^2 for vitl: 32 frames, 1370 tokens, 16 heads of
64. K1 (``kernels/spatial_attention.py``, with ``mxu_denom=True`` as the
JAX tool runs its kernel) works on the model's packed [B, S, H*dh]
layout. The library side is ``scaled_dot_product_attention`` under
``sdpa_kernel(SDPBackend.FLASH_ATTENTION)``, which wants [B, H, S, dh]:
its time includes the head split to head-major copies before the call and
the merge after it, which the model would pay. It needs no padding: the
flash backend takes any sequence length (the JAX stock kernel needed S
padded to its 512 blocks). The agreement of the two on the first two
frames is printed as max |diff|. Each time is the best of ITERS chains of
CHAIN calls between CUDA events (``timing.best_ms``); K1 is timed again
after the library, and stock / ours uses K1's better time. ``measure`` is
the measurement, for chip_smoke.py too. Needs a CUDA card and exits 2
without one.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..kernels.spatial_attention import spatial_attention
from .timing import bound_ms, best_ms, card_line

B, S, H, DH = 32, 1370, 16, 64
CHAIN = 8
ITERS = 8
KERNELS_TIMED = ("spatial_attention",)


def stock(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """The flash backend on head-major copies, merged back to [B, S, C]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, c = q.shape

    def to4(x):
        return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2).contiguous()

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(to4(q), to4(k), to4(v), scale=scale)
    return o.transpose(1, 2).reshape(b, s, c)


@torch.no_grad()
def measure(b: int = B, s: int = S, h: int = H, dh: int = DH, iters: int = ITERS,
            chain: int = CHAIN, seed: int = 0) -> dict:
    """The agreement and the times (ms per call); also printed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = h * dh
    scale = dh ** -0.5
    q, k, v = (torch.randn(b, s, c, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    flops = 4 * b * h * s * s * dh
    bms, by = bound_ms(flops, 4 * b * s * c * 2)

    def ours():
        return spatial_attention(q, k, v, num_heads=h, scale=scale, mxu_denom=True)

    def lib():
        return stock(q, k, v, h, scale)

    print(f"spatial attention A/B, b={b} s={s} h={h} dh={dh}, chain={chain}, best of "
          f"{iters}; bound {bms:.4f} ms ({by})", flush=True)
    a = spatial_attention(q[:2], k[:2], v[:2], num_heads=h, scale=scale, mxu_denom=True)
    diff = (a.float() - stock(q[:2], k[:2], v[:2], h, scale).float()).abs().max().item()
    print(f"  agreement ours vs stock: max|diff| = {diff:.2e}", flush=True)
    rec = dict(max_abs_diff=diff, bound_ms=bms, bound_by=by, card=card_line())

    def report(label, fn):
        ms = best_ms(fn, chain, iters)
        print(f"  {label:28s} {ms:8.3f} ms/call  {flops / ms / 1e9:7.2f} TF/s", flush=True)
        return ms

    rec["ours_ms"] = report("ours (packed bf16)", ours)
    rec["stock_ms"] = report("stock flash (+layout)", lib)
    rec["ours_rerun_ms"] = report("ours (re-run)", ours)
    rec["stock_over_ours"] = rec["stock_ms"] / min(rec["ours_ms"], rec["ours_rerun_ms"])
    print(f"  stock/ours: {rec['stock_over_ours']:.3f}x", flush=True)
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dims = [int(a) for a in argv[:4]] + [B, S, H, DH][len(argv[:4]):]
    if not torch.cuda.is_available():
        print("bench_stock_flash: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    measure(*dims)
    return 0


if __name__ == "__main__":
    sys.exit(main())
