"""A 3x3 conv in bf16 against the same conv in int8, on the card.

    python -m video_depth_anything_torch.tools.bench_int8_conv

The port of the JAX package's ``tools/bench_int8_conv.py``, which asked
whether an int8 conv reaches the doubled int8 rate. The shape is the DPT
RefineNet's at vitl 518^2: 32x148x148x256 -> 256, 3x3, stride 1, same
padding. Two ways:

  bf16 conv    ``ops/nn.py::conv2d`` (cuDNN, NHWC);
  int8 conv    w8a8 with int32 accumulation: the 9 shifted copies of the
               padded input stacked along channels (im2col, [N*H*W, 9C])
               and one ``torch._int_mm`` against the [9C, C] weight
               (cuBLAS). PyTorch has no int8 convolution on CUDA, so this
               is the int8 conv a PyTorch model can run; its time includes
               the im2col copy.

Each is the best of ITERS chains of CHAIN calls between CUDA events
(``timing.best_ms``), with its TF/s (TOP/s) against ``timing.PEAK_OPS``
and its bound. The inputs are made in ``measure``, not at import.
Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import nn as vnn
from .timing import PEAK_OPS, best_ms, bound_ms, card_line

B, H, W, C = 32, 148, 148, 256
K = 3
CHAIN = 8
ITERS = 5
KERNELS_TIMED = ()


def im2col(x: torch.Tensor, k: int = K) -> torch.Tensor:
    """x [N, H, W, C] -> [N*H*W, k*k*C]: the k x k neighbourhood of each
    pixel (zero padded), taps in (dy, dx) order, channels innermost."""
    n, h, w, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(k) for dx in range(k)],
                     dim=-1)
    return cols.reshape(n * h * w, k * k * c)


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """An OIHW int8 weight -> [k*k*Cin, Cout] in im2col's order, column-major
    (as ``torch._int_mm`` takes its second operand on the card)."""
    co, ci, kh, kw = w.shape
    return w.permute(0, 2, 3, 1).reshape(co, kh * kw * ci).t()


def conv_int8(x8: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """int8 NHWC x, ``int8_weight`` -> int32 NHWC, exact."""
    n, h, w, _ = x8.shape
    return torch._int_mm(im2col(x8), wm).reshape(n, h, w, wm.shape[1])


@torch.no_grad()
def measure(iters: int = ITERS, chain: int = CHAIN, seed: int = 0) -> list[dict]:
    """Time both convs at the tool's shape; one dict each, also printed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_f = torch.randn(B, H, W, C, device="cuda", generator=gen).to(torch.bfloat16)
    w_f = (0.05 * torch.randn(C, C, K, K, device="cuda", generator=gen)).to(torch.bfloat16)
    x_i = torch.randint(-127, 128, (B, H, W, C), device="cuda", generator=gen, dtype=torch.int8)
    w_i = int8_weight(torch.randint(-127, 128, (C, C, K, K), device="cuda", generator=gen,
                                    dtype=torch.int8))
    ops = 2.0 * B * H * W * C * C * K * K
    rows, card = [], card_line()
    for name, fn, dtype, out_size in (
            ("bf16 conv", lambda: vnn.conv2d(x_f, w_f, None, padding=1), "bfloat16", 2),
            ("int8 conv", lambda: conv_int8(x_i, w_i), "int8", 4)):
        x, w = (x_f, w_f) if dtype == "bfloat16" else (x_i, w_i)
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + B * H * W * C * out_size)
        ms = best_ms(fn, chain, iters)
        bms, by = bound_ms(ops, nbytes, dtype)
        rate = ops / ms / 1e9
        unit = "TOP/s" if dtype == "int8" else "TF/s"
        rows.append(dict(name=name, ms=ms, rate=rate, unit=unit,
                         peak_frac=rate * 1e12 / PEAK_OPS[dtype], bound_ms=bms, bound_by=by,
                         card=card))
        print(f"{name:12s}: {ms:8.3f} ms  {rate:7.1f} {unit} ({100 * rows[-1]['peak_frac']:5.1f} "
              f"% of peak), bound {bms:.3f} ms ({by})", flush=True)
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_int8_conv: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main())
