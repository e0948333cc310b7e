"""Attention on one fused qkv array: kernel K5 and its plain version.

Replaces the JAX package's ``ops/pallas_attention.py::
flash_attention_qkv_fused``, which runs K1's Pallas body on column blocks
of the fused projection output. Here K5 is K1's CUDA entry
(``csrc/spatial_attention.cu``) launched at scale 1 on the three column
views of ``qkv`` (row stride 3C, no copy), counted on this wrapper. A
head dim other than 64 goes to K4 on split-head views, as the JAX wrapper
falls back. Not routed in the model, as in the JAX package.

qkv is ``[B, S, 3C]``, laid out ``[q | k | v]`` with q already scaled; the
output is a contiguous ``[B, S, C]``. A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. ``mxu_denom`` is
K1's switch (the JAX wrapper's option of that name; JAX has no ``exp2``
here).
"""
from __future__ import annotations

import torch

from . import spatial_attention as k1
from .grad import refuse_grad


def _split(qkv: torch.Tensor):
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, S, 3C]: {tuple(qkv.shape)}")
    c = qkv.shape[2] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def spatial_attention_qkv_fused_plain(qkv: torch.Tensor, *, num_heads: int,
                                      mxu_denom: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: K1's plain version at scale 1."""
    q, k, v = _split(qkv)
    return k1.spatial_attention_plain(q, k, v, num_heads=num_heads, scale=1.0,
                                      mxu_denom=mxu_denom)


def spatial_attention_qkv_fused(qkv: torch.Tensor, *, num_heads: int,
                                mxu_denom: bool = False) -> torch.Tensor:
    """Multi-head attention on a fused [B, S, 3C] (q pre-scaled) -> [B, S, C]."""
    refuse_grad("spatial_attention_qkv_fused (K5)", qkv)
    q, k, v = _split(qkv)
    if q.shape[2] != num_heads * k1.HEAD_DIM:   # K4
        return k1.spatial_attention(q, k, v, num_heads=num_heads, scale=1.0, mxu_denom=mxu_denom)
    if qkv.device.type == "cpu":
        return spatial_attention_qkv_fused_plain(qkv, num_heads=num_heads, mxu_denom=mxu_denom)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"spatial_attention_qkv_fused runs on cuda or cpu, not {qkv.device}")
    out = k1.launch(q, k, v, num_heads=num_heads, scale=1.0, mxu_denom=mxu_denom)
    spatial_attention_qkv_fused.launches += 1
    return out


spatial_attention_qkv_fused.launches = 0
