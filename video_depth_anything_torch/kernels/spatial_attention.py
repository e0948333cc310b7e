"""Spatial attention of the ViT blocks: kernel K1 and its plain version.

Replaces the JAX package's ``ops/pallas_attention.py::
flash_attention_packed``. The CUDA source, with the note on its bound and
design, is ``csrc/spatial_attention.cu``.

q, k, v are ``[B, S, H*64]`` views with unit innermost stride, read in
place: the fused ``attn.qkv`` projection output ``[B, S, 3C]`` goes in as
three column views with row stride 3C and no copy. The output is a
contiguous ``[B, S, C]``. A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import merge_heads, mha, split_heads
from . import build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernel moves 16-byte vectors


def spatial_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, num_heads: int, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, softmax and
    accumulation, unnormalised probabilities rounded to v's dtype."""
    return merge_heads(mha(split_heads(q, num_heads), split_heads(k, num_heads),
                           split_heads(v, num_heads), scale))


def _bind():
    fn = build.library("spatial_attention").vda_spatial_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v, num_heads):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [B, S, C] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    c = q.shape[2]
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} only: "
                         f"C={c}, num_heads={num_heads}")
    vec = _ALIGN // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec
                or t.data_ptr() % _ALIGN):
            raise ValueError(f"{name} needs unit innermost stride, strides "
                             f"that are multiples of {vec} and a {_ALIGN}-byte "
                             f"aligned start: strides {t.stride()}")


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_heads: int, scale: float) -> torch.Tensor:
    """Multi-head attention on [B, S, H*64] -> contiguous [B, S, H*64]."""
    if q.device.type == "cpu":
        return spatial_attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"spatial_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, num_heads)
    b, s, c = q.shape
    out = torch.empty((b, s, c), dtype=q.dtype, device=q.device)
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, num_heads, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"spatial_attention kernel launch failed: cudaError {err}")
    spatial_attention.launches += 1
    return out


spatial_attention.launches = 0
