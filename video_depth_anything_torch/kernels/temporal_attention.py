"""Temporal attention of the motion modules: kernel K2 and its plain version.

Replaces the JAX package's ``ops/pallas_temporal_attention.py::
temporal_flash_attention`` (and the XLA form the JAX model routes on the
TPU, ``ops/attention.py::temporal_flat_attention``). The CUDA source, with
the note on its bound and design, is ``csrc/temporal_attention.cu``.

q, k, v are contiguous ``[P, T, C]`` with head h owning channels
``[h*dh, (h+1)*dh)`` and T <= 32. q is pre-scaled by ``scale`` in its own
dtype (the scale itself rounded to that dtype, as the JAX code does). A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import mha
from . import build

MAX_FRAMES = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale_in(dtype: torch.dtype, scale: float) -> float:
    """The scale as the JAX code applies it: rounded to the q dtype."""
    return float(torch.tensor(scale, dtype=dtype))


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, num_heads: int,
                             scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, per (pixel, head)."""
    p, t, c = q.shape
    dh = c // num_heads

    def heads(x):
        return x.reshape(p, t, num_heads, dh).transpose(1, 2)

    qs = q * _scale_in(q.dtype, scale)
    o = mha(heads(qs), heads(k), heads(v), 1.0)
    return o.transpose(1, 2).reshape(p, t, c)


def _bind():
    fn = build.library("temporal_attention").vda_temporal_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v, num_heads):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [P, T, C] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous [P, T, C]")
    t, c = q.shape[1], q.shape[2]
    if not 1 <= t <= MAX_FRAMES:
        raise ValueError(f"T={t} frames; the kernel takes 1..{MAX_FRAMES}")
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by num_heads={num_heads}")


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       num_heads: int, scale: float) -> torch.Tensor:
    """Per-pixel multi-head attention over frames: [P, T, C] -> [P, T, C]."""
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"temporal_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, num_heads)
    p, t, c = q.shape
    out = torch.empty_like(q)
    if p == 0:
        return out
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), p, t, num_heads, c // num_heads,
                 _scale_in(q.dtype, scale), stream)
    if err != 0:
        raise RuntimeError(f"temporal_attention kernel launch failed: cudaError {err}")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0
