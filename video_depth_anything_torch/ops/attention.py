"""Plain multi-head attention, the arithmetic the attention kernels share.

``mha`` is the port's counterpart of the JAX package's ``_xla_mha``
(ops/attention.py) in the epilogue-denominator form its kernels use:
fp32 scores, fp32 row max and sum, unnormalised probabilities rounded to
the value dtype for the PV product with fp32 accumulation, and the
1/denominator applied to the [*, D] output; with the kernels' switches for
the denominator (``mxu_denom``) and the base of the exponential
(``exp2``). The kernels' plain versions
(``kernels/spatial_attention.py``, ``kernels/temporal_attention.py``,
``kernels/attention_head_major.py``) are layout wrappers around it.
"""
from __future__ import annotations

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *,
        mxu_denom: bool = False, exp2: bool = False) -> torch.Tensor:
    """q, k, v: [..., S, D] head-major -> [..., S, D] in q's dtype.

    ``mxu_denom``: the denominator sums the probabilities after their
    rounding to v's dtype (what the JAX kernels compute with either
    ``mxu_denom`` setting); without it, the fp32 probabilities (the port's
    own choice). ``exp2``: the scores are in the log2 domain (the caller
    folded log2(e) into q) and are exponentiated in base 2."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    e = (torch.exp2 if exp2 else torch.exp)(s - s.amax(-1, keepdim=True))
    p = e.to(v.dtype).float()
    denom = (p if mxu_denom else e).sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float())
    return (o / denom).to(q.dtype)


LOG2E = 1.4426950408889634   # exp(x) == exp2(x * log2(e))


def scale_in(dtype: torch.dtype, scale: float) -> float:
    """The softmax scale as the JAX code pre-scales q with it: rounded to
    q's dtype, the product then rounded again."""
    return float(torch.tensor(scale, dtype=dtype))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] (heads contiguous) -> [B, H, S, dh] view."""
    b, s, c = x.shape
    return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> contiguous [B, S, H*dh]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
