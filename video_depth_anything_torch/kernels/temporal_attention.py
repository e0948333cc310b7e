"""Temporal attention of the motion modules: kernel K2 and its plain version.

Replaces the JAX package's ``ops/pallas_temporal_attention.py::
temporal_flash_attention`` (and the XLA form the JAX model routes on the
TPU, ``ops/attention.py::temporal_flat_attention``). The CUDA source, with
the note on its bound and design, is ``csrc/temporal_attention.cu``.

q, k, v are contiguous ``[P, T, C]`` with head h owning channels
``[h*dh, (h+1)*dh)`` and T <= 32. q is pre-scaled by ``scale`` in its own
dtype (the scale itself rounded to that dtype, as the JAX code does). A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises, both through the custom op ``vda::temporal_attention``
(``kernels/__init__.py``). The bf16 kernel works on head dims in blocks of 8
channels, up to 512: another head dim is padded with zero channels per
head around the launch (they change no score, and their outputs are
dropped).

Under a gradient (grad mode on and an input that requires grad) the
wrapper goes through ``TemporalAttentionFunction``: the forward is the
op, and the backward is the custom op ``vda::temporal_attention_backward``
at the saved q, k, v (nothing else is saved). Its CPU implementation is
the gradient of ``temporal_attention_plain``, recomputed under autograd;
its CUDA implementation is the backward kernel
(``csrc/temporal_attention_backward.cu``), which recomputes P from q and k
and launches or raises. The JAX package has no backward kernel (no
``custom_vjp``: XLA differentiates its motion modules through
``temporal_flat_attention`` / ``temporal_mha``); the kernel is the
counterpart of that fused gradient. T <= 32, so the recomputed
probabilities are at most [P, H, 32, 32].
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.attention import mha, scale_in
from . import build
from .grad import check_device

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


def _bind_backward():
    fn = build.library("temporal_attention_backward").vda_temporal_attention_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
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
    """K2 forward; backward: ``vda::temporal_attention_backward`` (module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return temporal_attention_op(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        grads = temporal_attention_backward(*ctx.saved_tensors, do, num_heads=ctx.num_heads,
                                            scale=ctx.scale)
        return (*(g if n else None for g, n in zip(grads, ctx.needs_input_grad[:3])), None, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       num_heads: int, scale: float) -> torch.Tensor:
    """Per-pixel multi-head attention over frames: [P, T, C] -> [P, T, C]."""
    check_device("temporal_attention", q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return TemporalAttentionFunction.apply(q, k, v, num_heads, scale)
    return temporal_attention_op(q, k, v, num_heads, float(scale))


@torch.library.custom_op("vda::temporal_attention", mutates_args=(), device_types="cpu")
def temporal_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    return temporal_attention_plain(q, k, v, num_heads=num_heads, scale=scale)


@temporal_attention_op.register_kernel("cuda")
def _launch(q, k, v, num_heads, scale):
    """K2 on CUDA tensors, counted."""
    _check(q, k, v, num_heads)
    p, t, c = q.shape
    dh = c // num_heads
    if p == 0:
        return torch.empty_like(q)
    if q.dtype == torch.bfloat16 and dh % 8:
        dp = -(-dh // 8) * 8
        out = _launch(*(pad_heads(x, num_heads, dp) for x in (q, k, v)), num_heads, scale)
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


@temporal_attention_op.register_fake
def _(q, k, v, num_heads, scale):
    return q.new_empty(q.shape)


temporal_attention.launches = 0


def temporal_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      do: torch.Tensor, *, num_heads: int,
                                      scale: float) -> tuple[torch.Tensor, ...]:
    """dq, dk, dv: the gradient of ``temporal_attention_plain`` at q, k, v
    against ``do``, recomputed under autograd, each contiguous (as the
    kernel's). The custom op runs its implementations below autograd's
    dispatch keys (``torch.library`` excludes them), so this turns them
    back on for its own graph."""
    autograd = torch._C._SetExcludeDispatchKeyGuard(torch._C.DispatchKey.AutogradFunctionality,
                                                    False)
    with autograd, torch.enable_grad():
        a = [x.detach().requires_grad_() for x in (q, k, v)]
        o = temporal_attention_plain(*a, num_heads=num_heads, scale=scale)
        return tuple(g.contiguous() for g in torch.autograd.grad(o, a, do))


def temporal_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                do: torch.Tensor, *, num_heads: int,
                                scale: float) -> tuple[torch.Tensor, ...]:
    """The gradient of ``temporal_attention`` at q, k, v against ``do``:
    (dq, dk, dv), each [P, T, C] in q's dtype."""
    check_device("temporal_attention_backward", q)
    return temporal_attention_backward_op(q, k, v, do, num_heads, float(scale))


@torch.library.custom_op("vda::temporal_attention_backward", mutates_args=(),
                         device_types="cpu")
def temporal_attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   do: torch.Tensor, num_heads: int,
                                   scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return temporal_attention_backward_plain(q, k, v, do, num_heads=num_heads, scale=scale)


@temporal_attention_backward_op.register_kernel("cuda")
def _launch_backward(q, k, v, do, num_heads, scale):
    """The backward kernel on CUDA tensors, counted."""
    _check(q, k, v, num_heads)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype} {do.device} against "
                         f"{tuple(q.shape)} {q.dtype} {q.device}")
    p, t, c = q.shape
    dh = c // num_heads
    if p == 0:
        return tuple(torch.empty_like(q) for _ in range(3))
    if q.dtype == torch.bfloat16 and dh % 8:
        dp = -(-dh // 8) * 8
        grads = _launch_backward(*(pad_heads(x, num_heads, dp) for x in (q, k, v, do)),
                                 num_heads, scale)
        return tuple(g.reshape(p, t, num_heads, dp)[..., :dh].reshape(p, t, c) for g in grads)
    q, k, v, do = (x if x.data_ptr() % _ALIGN == 0 else x.clone()
                   for x in (q, k, v, do.contiguous()))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _bind_backward()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), p, t, num_heads, dh,
                 scale_in(q.dtype, scale), stream)
    if err != 0:
        raise RuntimeError(f"temporal_attention_backward kernel launch failed: cudaError {err}")
    temporal_attention_backward.launches += 1
    return dq, dk, dv


@temporal_attention_backward_op.register_fake
def _(q, k, v, do, num_heads, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


temporal_attention_backward.launches = 0
