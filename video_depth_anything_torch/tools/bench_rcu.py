"""Card microbench: kernel K6 (the fused residual conv unit) against the
two-conv path it replaces.

    python -m video_depth_anything_torch.tools.bench_rcu

The port of the JAX package's ``tools/bench_rcu.py``. The shapes are the
RefineNet residual conv unit inputs of vitl at 518x518 (one 32-frame
window, 256 features); ``VITG_SHAPES`` are vitg's (384 features). For each, in bf16, it prints the time and TF/s of
the unit's default path (relu, cuDNN conv, relu, cuDNN conv, add) and of
K6 (``use_kernel=True``), their ratio, K6's max abs error against its
plain version and the least time the card could take (the larger of the
operations at the bf16 tensor-core peak and the bytes at the HBM rate).
Needs a CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import sys

import torch

from . import timing
from .timing import time_ms

SHAPES = [(32, 148, 148, 256), (32, 74, 74, 256), (32, 37, 37, 256), (32, 19, 19, 256)]
# vitg's RefineNet units (384 features): the kernel's widest C.
VITG_SHAPES = [(32, 148, 148, 384), (32, 74, 74, 384), (32, 37, 37, 384), (32, 19, 19, 384)]


def flops(shape) -> float:
    n, h, w, c = shape
    return 4.0 * n * h * w * 9 * c * c


def bound_ms(shape, itemsize: int = 2):
    """(ms, "operations" or "bytes"): x read and y written once."""
    n, h, w, c = shape
    return timing.bound_ms(flops(shape), 2 * n * h * w * c * itemsize)


@torch.no_grad()
def random_unit(c: int, gen: torch.Generator, dtype: torch.dtype = torch.bfloat16):
    """A ResidualConvUnit on the card in ``dtype``, weights N(0, 0.04^2) and
    biases N(0, 0.1^2) drawn from ``gen``."""
    from ..models.dpt import ResidualConvUnit

    rcu = ResidualConvUnit(c).to("cuda")
    for conv in (rcu.conv1, rcu.conv2):
        conv.weight.copy_(0.04 * torch.randn(conv.weight.shape, device="cuda", generator=gen))
        conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, device="cuda", generator=gen))
    return rcu.to(dtype)


@torch.no_grad()
def bench(shapes=SHAPES, iters: int = 10, seed: int = 0) -> list[dict]:
    """Time both paths of a bf16 residual conv unit at each shape; one dict
    per shape, also printed."""
    from ..kernels.fused_rcu import fused_rcu_plain

    if not torch.cuda.is_available():
        raise RuntimeError("bench_rcu needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for shape in shapes:
        rcu = random_unit(shape[3], gen)
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        got = rcu(x, use_kernel=True)
        ref = fused_rcu_plain(x, *rcu.kernel_operands(x.dtype))
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        chain = time_ms(lambda: rcu(x), iters)
        kernel = time_ms(lambda: rcu(x, use_kernel=True), iters)
        bms, by = bound_ms(shape)
        row = dict(shape=list(shape), chain_ms=chain, kernel_ms=kernel,
                   chain_tflops=flops(shape) / chain / 1e9,
                   kernel_tflops=flops(shape) / kernel / 1e9,
                   chain_over_kernel=chain / kernel, max_abs_err=err, ref_max_abs=ref_max,
                   bound_ms=bms, bound_by=by)
        print(f"{tuple(shape)} bf16: two-conv path {chain:.3f} ms ({row['chain_tflops']:.1f} "
              f"TF/s), K6 {kernel:.3f} ms ({row['kernel_tflops']:.1f} TF/s), chain / K6 "
              f"{row['chain_over_kernel']:.2f}x, max abs err {err:.3e} (max |y| {ref_max:.3f}), "
              f"bound {bms:.3f} ms ({by})", flush=True)
        rows.append(row)
        del rcu, x, got, ref
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_rcu: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())
