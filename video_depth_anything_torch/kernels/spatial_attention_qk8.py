"""Spatial attention with int8 QK (``--int8``): kernel K3 and its plain version.

Replaces the JAX package's ``ops/pallas_attention.py::
flash_attention_packed_qk8``. The CUDA source, with the note on its bound
and design, is ``csrc/spatial_attention_qk8.cu``.

q8 and k8 are contiguous int8 ``[B, S, H*64]`` (``quant_act`` outputs); v
is a ``[B, S, H*64]`` float view with unit innermost stride, read in place
(a column view of the fused qkv output); scales is fp32 ``[2]`` on v's
device, ``(sq, sk)`` with the attention scale folded into sq. Per head:

    s = int32(q8 k8^T); p = exp((s - rowmax s) * sq * sk) rounded to v's
    dtype; o = p v / sum(p), fp32 accumulation.

As in the JAX package, an odd head count, S > 8448 or a head dim other
than 64 takes the fallback: q and k dequantized to v's dtype and
``spatial_attention`` at scale 1 (K1, or K4 for dh != 64). A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import merge_heads, split_heads
from . import build
from .grad import refuse_grad
from .spatial_attention import spatial_attention

HEAD_DIM = 64
MAX_S = 66 * 128   # the JAX kernel's padded-key limit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernel moves 16-byte vectors


def spatial_attention_qk8_plain(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                                scales: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch. The fp32 product of the int8
    values is exact (|s| <= 64 * 127^2 < 2^24), so the scores are the
    kernel's integers."""
    qh, kh, vh = (split_heads(t, num_heads) for t in (q8, k8, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    c = scales[0].float() * scales[1].float()
    e = torch.exp((s - s.amax(-1, keepdim=True)) * c)
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(e.to(v.dtype).float(), vh.float()) / denom
    return merge_heads(o.to(v.dtype))


def _fallback(q8, k8, v, scales, num_heads):
    """Dequantize q and k to v's dtype and run K1 (K4 for dh != 64) at scale 1."""
    qf = q8.to(v.dtype) * scales[0].to(v.dtype)
    kf = k8.to(v.dtype) * scales[1].to(v.dtype)
    return spatial_attention(qf, kf, v, num_heads=num_heads, scale=1.0)


def _bind():
    fn = build.library("spatial_attention_qk8").vda_spatial_attention_qk8
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    return fn


def _check(q8, k8, v, scales, num_heads):
    if not (q8.shape == k8.shape == v.shape) or q8.dim() != 3:
        raise ValueError(f"q8, k8, v must share one [B, S, C] shape: "
                         f"{tuple(q8.shape)} {tuple(k8.shape)} {tuple(v.shape)}")
    if q8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise TypeError(f"q8 and k8 must be int8, got {q8.dtype} {k8.dtype}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    if scales.dtype != torch.float32 or scales.shape != (2,) or not scales.is_contiguous():
        raise ValueError(f"scales must be a contiguous fp32 [2], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not (q8.device == k8.device == v.device == scales.device):
        raise ValueError("q8, k8, v and scales must be on one device")
    c = q8.shape[2]
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} only: "
                         f"C={c}, num_heads={num_heads}")
    for name, t in (("q8", q8), ("k8", k8)):
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous with a {_ALIGN}-byte aligned start")
    vec = _ALIGN // v.element_size()
    if (v.stride(2) != 1 or v.stride(0) % vec or v.stride(1) % vec
            or v.data_ptr() % _ALIGN):
        raise ValueError(f"v needs unit innermost stride, strides that are "
                         f"multiples of {vec} and a {_ALIGN}-byte aligned start: "
                         f"strides {v.stride()}")


def spatial_attention_qk8(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                          scales: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """int8-QK multi-head attention on [B, S, H*64] -> contiguous [B, S, H*64]
    in v's dtype."""
    refuse_grad("spatial_attention_qk8 (K3)", q8, k8, v, scales)
    if num_heads % 2 or q8.shape[1] > MAX_S or q8.shape[2] != num_heads * HEAD_DIM:
        return _fallback(q8, k8, v, scales, num_heads)
    if q8.device.type == "cpu":
        return spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=num_heads)
    if q8.device.type != "cuda":
        raise RuntimeError(f"spatial_attention_qk8 runs on cuda or cpu, not {q8.device}")
    _check(q8, k8, v, scales, num_heads)
    b, s, c = q8.shape
    out = torch.empty((b, s, c), dtype=v.dtype, device=v.device)
    fn = _bind()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(_DTYPES[v.dtype], q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), b, s, num_heads,
                 v.stride(0), v.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"spatial_attention_qk8 kernel launch failed: cudaError {err}")
    spatial_attention_qk8.launches += 1
    return out


spatial_attention_qk8.launches = 0
