"""Temporal attention of the motion modules: kernel K2 and its plain version.

Replaces the JAX package's ``ops/pallas_temporal_attention.py::
temporal_flash_attention`` (and the XLA form the JAX model routes on the
TPU, ``ops/attention.py::temporal_flat_attention``). The CUDA source, with
the note on its bound and design, is ``csrc/temporal_attention.cu``.

q, k, v are contiguous ``[P, T, C]`` with head h owning channels
``[h*dh, (h+1)*dh)`` and T <= 32. q is pre-scaled by ``scale`` in its own
dtype (the scale itself rounded to that dtype, as the JAX code does). A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. The bf16 kernel works on head dims in blocks of 8
channels, up to 512: another head dim is padded with zero channels per
head around the launch (they change no score, and their outputs are
dropped).

Under a gradient (grad mode on and an input that requires grad) the
wrapper goes through ``TemporalAttentionFunction``: the forward is K2 (the
plain version on the CPU), and the backward is the gradient of
``temporal_attention_plain`` at the saved q, k, v, recomputed in plain
PyTorch. The JAX package has no backward kernel to port (no
``custom_vjp``: XLA differentiates its motion modules through
``temporal_flat_attention`` / ``temporal_mha``), so this plain backward is
the port of what JAX does, not a fallback. T <= 32, so the recomputed
probabilities are at most [P, H, 32, 32].
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.attention import mha, scale_in
from . import build

MAX_FRAMES = 32
MAX_BF16_HEAD_DIM = 512   # two tiles of one head's q, k, v fill a block's shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16   # bytes: the bf16 kernel moves 16-byte vectors


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, num_heads: int,
                             scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, per (pixel, head)."""
    p, t, c = q.shape
    dh = c // num_heads

    def heads(x):
        return x.reshape(p, t, num_heads, dh).transpose(1, 2)

    qs = q * scale_in(q.dtype, scale)
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
    if q.dtype == torch.bfloat16 and c // num_heads > MAX_BF16_HEAD_DIM:
        raise ValueError(f"head dim {c // num_heads}: the bf16 kernel takes head dims "
                         f"up to {MAX_BF16_HEAD_DIM}")


def pad_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """[P, T, H*dh] -> contiguous [P, T, H*head_dim], each head's channels
    followed by zeros."""
    p, t, c = x.shape
    dh = c // num_heads
    return F.pad(x.reshape(p, t, num_heads, dh), (0, head_dim - dh)).reshape(
        p, t, num_heads * head_dim)


class TemporalAttentionFunction(torch.autograd.Function):
    """K2 forward; backward: the plain version's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_(n) for x, n in zip(saved, need))
            o = temporal_attention_plain(q, k, v, num_heads=ctx.num_heads, scale=ctx.scale)
            wrt = [x for x, n in zip((q, k, v), need) if n]
            grads = iter(torch.autograd.grad(o, wrt, do))
        return (*(next(grads) if n else None for n in need), None, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       num_heads: int, scale: float) -> torch.Tensor:
    """Per-pixel multi-head attention over frames: [P, T, C] -> [P, T, C]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return TemporalAttentionFunction.apply(q, k, v, num_heads, scale)
    return _forward(q, k, v, num_heads, scale)


def _forward(q, k, v, num_heads, scale):
    """The plain version on the CPU; K2 on a CUDA tensor, counted."""
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"temporal_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, num_heads)
    p, t, c = q.shape
    dh = c // num_heads
    if p == 0:
        return torch.empty_like(q)
    if q.dtype == torch.bfloat16 and dh % 8:
        dp = -(-dh // 8) * 8
        out = _forward(*(pad_heads(x, num_heads, dp) for x in (q, k, v)), num_heads, scale)
        return out.reshape(p, t, num_heads, dp)[..., :dh].reshape(p, t, c)
    q, k, v = (x if x.data_ptr() % _ALIGN == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), p, t, num_heads, dh,
                 scale_in(q.dtype, scale), stream)
    if err != 0:
        raise RuntimeError(f"temporal_attention kernel launch failed: cudaError {err}")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0
