"""cuBLAS GEMM rates by shape on the card (chain-differenced timing).

    python -m video_depth_anything_torch.tools.bench_mxu_geometry

The port of the JAX package's ``tools/bench_mxu_geometry.py``, which timed
plain XLA matrix products to find the shapes that run below the matrix
unit's peak. Here each product is one PyTorch call, cuBLAS on the card:
``torch.mm(a, b, out_dtype=torch.float32)`` for bf16 (an fp32 result, as
the JAX tool's ``preferred_element_type``) and ``torch._int_mm`` for int8
(int32 accumulation). Rows:

  dense peaks       bf16 at 4096^3 and 2048^3, int8 at 4096^3;
  encoder-shaped    M = 32 x 1408 (a window's frames folded into M): qkv
                    1024 -> 3072, mlp-up 1024 -> 4096, mlp-dn 4096 -> 1024,
                    proj 1024 -> 1024;
  attention-shaped  1408 rows: qk64, qk128, pv128, pv256, pv512. A call
                    takes microseconds there, about what the host needs to
                    launch it, so these rows read the launch rate as much
                    as the tensor cores.

Each time is ``timing.marginal_ms``: chains sized so that the marginal card
time between them is TARGET_MARGIN_S at an assumed EST_TF, the medians of
ITERS timings of each, differenced. A rate over 105 % of
``timing.PEAK_OPS`` for its type cannot be a product that ran in full: it
is printed as an error and the tool exits 1 (one such reading, taken from
a chain's edge, is why the check exists). ``rates`` is the measurement,
for chip_smoke.py too. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import sys

import torch

from .timing import PEAK_OPS, TARGET_MARGIN_S, bound_ms, card_line, marginal_ms

EST_TF = 120e12          # the rate assumed to size the chains (the JAX tool's)
OVER_PEAK = 1.05
KERNELS_TIMED = ()
# (section, tag, M, K, N, dtype): the JAX tool's shapes.
SHAPES = [
    ("dense peaks", "bf16 4096^3", 4096, 4096, 4096, "bfloat16"),
    ("dense peaks", "bf16 2048^3", 2048, 2048, 2048, "bfloat16"),
    ("dense peaks", "int8 4096^3", 4096, 4096, 4096, "int8"),
    ("encoder-shaped", "qkv", 32 * 1408, 1024, 3 * 1024, "bfloat16"),
    ("encoder-shaped", "mlp-up", 32 * 1408, 1024, 4096, "bfloat16"),
    ("encoder-shaped", "mlp-dn", 32 * 1408, 4096, 1024, "bfloat16"),
    ("encoder-shaped", "proj", 32 * 1408, 1024, 1024, "bfloat16"),
    ("attention-shaped", "qk64", 1408, 64, 1408, "bfloat16"),
    ("attention-shaped", "qk128", 1408, 128, 1408, "bfloat16"),
    ("attention-shaped", "pv128", 1408, 1408, 128, "bfloat16"),
    ("attention-shaped", "pv256", 1408, 1408, 256, "bfloat16"),
    ("attention-shaped", "pv512", 1408, 1408, 512, "bfloat16"),
]


def operands(m: int, k: int, n: int, dtype: str, gen: torch.Generator):
    """a [M, K] and b [K, N] on the card: 0.1 N(0, 1) in bf16, uniform
    int8 in [-127, 127] (b column-major, as cuBLAS takes int8 products)."""
    if dtype == "int8":
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int8).t()
        return a, b
    return tuple(0.1 * torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                 for shape in ((m, k), (k, n)))


def product(dtype: str):
    if dtype == "int8":
        return torch._int_mm
    return lambda a, b: torch.mm(a, b, out_dtype=torch.float32)


@torch.no_grad()
def rates(margin_s: float = TARGET_MARGIN_S, seed: int = 0) -> list[dict]:
    """Time every shape; one dict per shape (``over_peak`` set where the
    rate reads over 105 % of its peak), also printed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, section, card = [], None, card_line()
    for sec, tag, m, k, n, dtype in SHAPES:
        if sec != section:
            print(f"\n-- {sec} --", flush=True)
            section = sec
        a, b = operands(m, k, n, dtype, gen)
        ops = 2.0 * m * k * n
        ms = marginal_ms(product(dtype), a, b, est_call_ms=ops / EST_TF * 1e3, margin_s=margin_s)
        rate = ops / ms / 1e9
        out_bytes = m * n * 4
        bms, by = bound_ms(ops, a.numel() * a.element_size() + b.numel() * b.element_size()
                           + out_bytes, dtype)
        peak_frac = rate * 1e12 / PEAK_OPS[dtype]
        unit = "TOP/s" if dtype == "int8" else "TF/s"
        row = dict(section=sec, tag=tag, shape=[m, k, n], dtype=dtype, us=ms * 1e3, rate=rate,
                   unit=unit, peak_frac=peak_frac, bound_ms=bms, bound_by=by,
                   over_peak=peak_frac > OVER_PEAK, card=card)
        rows.append(row)
        print(f"{tag:12s} {m:6d}x{k}x{n}  {ms * 1e3:9.1f} us  {rate:7.1f} {unit} "
              f"({100 * peak_frac:5.1f} % of peak; bound {bms * 1e3:.1f} us, {by})", flush=True)
        if row["over_peak"]:
            print(f"ERROR: {tag} reads {100 * peak_frac:.1f} % of the {dtype} peak: not a "
                  f"product that ran in full", flush=True)
        del a, b
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_mxu_geometry: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    rows = rates()
    return 1 if any(r["over_peak"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
