"""Plain multi-head attention, the arithmetic both attention kernels share.

``mha`` is the port's counterpart of the JAX package's ``_xla_mha``
(ops/attention.py) in the epilogue-denominator form its kernels use:
fp32 scores, fp32 row max and sum, unnormalised probabilities rounded to
the value dtype for the PV product with fp32 accumulation, and the
1/denominator applied to the [*, D] output. The kernels' plain versions
(``kernels/spatial_attention.py``, ``kernels/temporal_attention.py``) are
layout wrappers around it.
"""
from __future__ import annotations

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """q, k, v: [..., S, D] head-major -> [..., S, D] in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] (heads contiguous) -> [B, H, S, dh] view."""
    b, s, c = x.shape
    return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> contiguous [B, S, H*dh]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
