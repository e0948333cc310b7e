"""Temporal attention at the motion modules' shapes, on the card: K2 against
its plain version, per-head attention and SDPA.

    python -m video_depth_anything_torch.tools.bench_temporal_kernel

The port of the JAX package's ``tools/bench_temporal_kernel.py``. At vitl's
four motion-module shapes for a 32-frame 518x518 window (P pixels, C
channels, 8 heads, T 32), bf16, it times:

  kernel    K2 (``kernels/temporal_attention.py``);
  flat      K2's plain version (one matmul per product over the pixels and
            heads, head-split views);
  head      per-head attention, ``ops/attention.py::mha`` on head-major
            copies of q, k, v (the JAX tool's ``xla-head``);
  sdpa      ``torch.nn.functional.scaled_dot_product_attention`` on the
            head-split views: the library baseline.

The port runs its motion modules ungrouped (the JAX model grouped dh-32
heads in fours for the TPU's 128 lanes), so the shapes are the modules'
own: (1369, 1024), (361, 1024), (1369, 256), (5476, 256). The JAX tool's
sweep of its kernel's VMEM budget has no counterpart: K2's tile is fixed.
The scale is the model's, dh^-0.5 (the JAX tool's 1.0 makes the softmax
one-hot at dh 128; the times do not depend on it), so that K2's agreement
with its plain version, printed per shape, is the model's. Each time is
the best of ITERS replays of a CUDA graph of CHAIN calls
(``timing.best_ms``): the smaller shapes take less card time than the
host needs to launch them. ``compare`` is the measurement, for
chip_smoke.py too. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..kernels.temporal_attention import temporal_attention, temporal_attention_plain
from ..ops.attention import merge_heads, mha
from .timing import best_ms, bound_ms, card_line

T = 32
HEADS = 8
CHAIN = 64
ITERS = 3
# (label, pixels P, channels C, heads): vitl's motion modules 0-3.
SHAPES = [
    ("m0 37^2 c1024", 1369, 1024, 8),
    ("m1 19^2 c1024", 361, 1024, 8),
    ("m2 37^2 c256", 1369, 256, 8),
    ("m3 74^2 c256", 5476, 256, 8),
]
KERNELS_TIMED = ("temporal_attention",)


def head_attention(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """Per-head attention on head-major copies: [P, T, C] -> [P, T, C]."""
    p, t, c = q.shape

    def heads(x):
        return x.reshape(p, t, num_heads, c // num_heads).transpose(1, 2).contiguous()

    o = mha(heads(q), heads(k), heads(v), scale)
    return o.transpose(1, 2).reshape(p, t, c)


def sdpa(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    p, t, c = q.shape

    def heads(x):
        return x.reshape(p, t, num_heads, c // num_heads).transpose(1, 2)

    return merge_heads(F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                      scale=scale))


@torch.no_grad()
def compare(shapes=SHAPES, iters: int = ITERS, chain: int = CHAIN, seed: int = 0) -> list[dict]:
    """Time the four forms at each shape; one dict per shape (with K2's
    max abs error against its plain version), also printed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, card = [], card_line()
    for label, p, c, nh in shapes:
        scale = (c // nh) ** -0.5
        q, k, v = (torch.randn(p, T, c, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        forms = {"kernel": temporal_attention, "flat": temporal_attention_plain,
                 "head": head_attention, "sdpa": sdpa}
        got = temporal_attention(q, k, v, num_heads=nh, scale=scale)
        ref = temporal_attention_plain(q, k, v, num_heads=nh, scale=scale)
        err = (got.float() - ref.float()).abs().max().item()
        bms, by = bound_ms(4 * p * T * T * c, 4 * p * T * c * 2)
        row = dict(label=label, shape=[p, T, c], heads=nh, max_abs_err=err,
                   ref_max_abs=ref.float().abs().max().item(), bound_ms=bms, bound_by=by,
                   card=card)
        print(f"{label}: P={p} C={c} H={nh}; K2 against its plain version: max|diff| = "
              f"{err:.2e}; bound {bms:.4f} ms ({by})", flush=True)
        for name, fn in forms.items():
            if name in ("kernel", "flat"):
                call = (lambda fn=fn: fn(q, k, v, num_heads=nh, scale=scale))
            else:
                call = (lambda fn=fn: fn(q, k, v, nh, scale))
            row[f"{name}_ms"] = best_ms(call, chain, iters, graph=True)
            print(f"  {name:10s}: {row[f'{name}_ms']:7.3f} ms", flush=True)
        rows.append(row)
        del q, k, v, got, ref
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_temporal_kernel: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    compare()
    return 0


if __name__ == "__main__":
    sys.exit(main())
