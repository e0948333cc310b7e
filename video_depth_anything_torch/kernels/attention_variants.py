"""K1's attention function under three schedules: T2 and its plain version.

Replaces ``tools/bench_kernel_phases.py::variant_attention`` (Pallas body
``_variant_kernel``), a measurement kernel: the same function as K1
(``kernels/spatial_attention.py``) with the phases of one query block
ordered three ways (``SCHEDULES``), so the phase bench
(``tools/bench_kernel_phases.py`` of this package) can time the orders
against each other and against K1. The CUDA source, with the note on its
bound and design, is ``csrc/attention_variants.cu``.

The function, as the tool defines it: q, k, v ``[B, S, H*64]``; q
pre-scaled by 64^-0.5 in its own dtype; fp32 scores; p = exp(s - rowmax)
rounded to v's dtype; o = (p v) / max(sum p, 1e-30), where the
denominator sums the rounded p: K1's function with ``mxu_denom=True`` at
scale 1/8 (a power of two, so the pre-scale is exact). The kernels are
instances of K1's body (``csrc/attention_flash.cuh``), ``stagger`` the very
instance K1 runs with ``mxu_denom=True``. The row max runs over the S
keys; the tool's padded keys (zero scores) do not enter it, which changes
no value in fp32.

The kernel takes contiguous bf16, as the tool runs it; the plain version
also takes fp32 (the CPU tests). A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. No served path runs
T2, so it stays a plain Python wrapper and is not a ``torch.library``
custom op (``kernels/__init__.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import merge_heads, scale_in, split_heads
from . import build

HEAD_DIM = 64
SCHEDULES = ("base", "stagger", "kchunk")
SCALE = HEAD_DIM ** -0.5


def attention_variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            num_heads: int) -> torch.Tensor:
    """The kernels' function in plain PyTorch (every schedule computes it)."""
    qh = split_heads(q * scale_in(q.dtype, SCALE), num_heads)
    s = torch.matmul(qh.float(), split_heads(k, num_heads).float().transpose(-1, -2))
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(v.dtype).float()
    o = torch.matmul(p, split_heads(v, num_heads).float())
    return merge_heads(o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _check(q, k, v, num_heads):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [B, S, C] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[2] != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} only: C={q.shape[2]}, "
                         f"num_heads={num_heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16 only: {name} is {t.dtype}")
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous and on q's device")


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_heads: int, schedule: str) -> torch.Tensor:
    """T2 under ``schedule`` (one of ``SCHEDULES``): [B, S, H*64] -> [B, S, H*64]."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if q.device.type == "cpu":
        return attention_variant_plain(q, k, v, num_heads=num_heads)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_variant runs on cuda or cpu, not {q.device}")
    _check(q, k, v, num_heads)
    b, s, c = q.shape
    out = torch.empty_like(q)
    fn = build.library("attention_variants").vda_attention_variant
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(SCHEDULES.index(schedule), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, num_heads, scale_in(q.dtype, SCALE), stream)
    if err != 0:
        raise RuntimeError(f"attention_variant ({schedule}) launch failed: cudaError {err}")
    attention_variant.launches += 1
    return out


attention_variant.launches = 0
