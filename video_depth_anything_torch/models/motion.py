"""Temporal motion modules: per-pixel attention over the frames of a window.

The port of the JAX package's ``models/motion.py``: GroupNorm(32,
eps 1e-6) -> proj_in -> (2 x [LayerNorm eps 1e-5 -> temporal attention
with the sinusoidal APE, or RoPE on q and k] + GEGLU feed-forward) ->
zero-initialised proj_out + residual. Maps are NHWC ``[B*T, H, W, C]``; the transformer
blocks run in the attention-native ``[B*H*W, T, C]`` layout (one transpose
in, one out), and the attention itself is kernel K2
(``kernels/temporal_attention.py``).

int8 mode (``ops/quant.py::quantize_motion_module``): every linear becomes
a ``QLinear``; to_q, to_k and to_v share one quantized input, and K2 runs
on their dequantized outputs. A ``stats`` dict passed to ``forward``
collects the calibration absmaxes, in the JAX package's tree.

On the mesh's model axis (``parallel/mesh.py::split_params``) an
attention block holds q, k and v of its rank's heads (K2 runs at the
local head count; the scale keeps the head dim) and the rows of the RoPE
table that rotate its channels; the APE is added before the projections
and stays whole. The GEGLU holds its rank's part of val and of gate. The
row-split products (to_out.0, ff.net.2) are summed over the group in
fp32 before their bias is added and they are rounded, once.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..kernels.temporal_attention import temporal_attention
from ..ops import nn as vnn
from ..ops import quant
from ..parallel.tensor import copy_to_model, max_over_model


def sinusoidal_pe(d_model: int, max_len: int) -> np.ndarray:
    """APE table [1, max_len, d_model]: sin on even channels, cos on odd."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * (-math.log(10000.0) / d_model))
    pe = np.zeros((1, max_len, d_model), dtype=np.float64)
    pe[0, :, 0::2] = np.sin(position * div)
    pe[0, :, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


def rope_freqs_cis(dim: int, end: int, theta: float = 10000.0) -> np.ndarray:
    """RoPE table [end, dim // 2] complex64: position t times frequency
    theta^(-2i / dim), as cos + i sin."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    angles = np.outer(np.arange(end, dtype=np.float64), freqs)
    return (np.cos(angles) + 1j * np.sin(angles)).astype(np.complex64)


class RotaryEmbedding(nn.Module):
    """The RoPE table as an fp32 [max_len, dim // 2, 2] (cos, sin) buffer.

    Not a checkpoint tensor (non-persistent), and fp32 whatever dtype the
    model is cast to: the JAX package keeps its complex64 table when it
    casts the parameters, so a cast rebuilds the table instead of rounding
    it. On a model axis ``pairs`` is the [lo, hi) range of channel pairs
    this rank's heads hold, and the table keeps those rows."""

    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.dim, self.max_len = dim, max_len
        self.pairs = (0, dim // 2)
        self.register_buffer("freqs", self._table(None), persistent=False)

    def _table(self, device) -> torch.Tensor:
        f = rope_freqs_cis(self.dim, self.max_len)[:, self.pairs[0]:self.pairs[1]]
        return torch.tensor(np.stack([f.real, f.imag], axis=-1), device=device)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        if self.freqs.dtype != torch.float32:
            self.freqs = self._table(self.freqs.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate the channel pairs of x [P, T, C] by position, in fp32
        (the complex product (a + ib)(cos + i sin)); cast back to x's dtype."""
        p, t, c = x.shape
        xf = x.float().reshape(p, t, c // 2, 2)
        a, b = xf[..., 0], xf[..., 1]
        cos, sin = self.freqs[:t, :, 0], self.freqs[:t, :, 1]
        out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
        return out.reshape(p, t, c).to(x.dtype)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.tensor(sinusoidal_pe(d_model, max_len)),
                             persistent=True)


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, max_len: int, pe: str = "ape"):
        super().__init__()
        self.num_heads = num_heads     # this rank's heads once split
        self.tp = None                 # the ModelAxis once split
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])
        if pe == "ape":
            self.pos_encoder = PositionalEncoding(dim, max_len)
        elif pe == "rope":
            self.rope = RotaryEmbedding(dim, max_len)
        else:
            raise ValueError(f"unknown temporal pe {pe!r}")
        self.pe = pe

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        """x: [P, T, C] -> [P, T, C]."""
        t = x.shape[1]
        if self.pe == "ape":
            x = x + self.pos_encoder.pe[:, :t].to(x.dtype)
        if stats is not None:
            stats["qkv"] = quant.amax(x)
        x = copy_to_model(x, self.tp)
        x_i8 = None
        if isinstance(self.to_q, quant.QLinear):
            x_i8 = quant.quant_act(x, self.to_q.amax)
        q, k, v = (quant.linear_maybe_q(m, x, x_i8) for m in (self.to_q, self.to_k, self.to_v))
        if self.pe == "rope":
            q, k = self.rope(q), self.rope(k)
        o = temporal_attention(q, k, v, num_heads=self.num_heads,
                               scale=(q.shape[-1] // self.num_heads) ** -0.5)
        if stats is not None:
            stats["out"] = max_over_model(quant.amax(o), self.tp)
        return quant.linear_maybe_q(self.to_out[0], o, tp=self.tp)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU feed-forward: val * gelu(gate) -> linear (inner = 4C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.tp = None
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Dropout(0.0),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        if stats is not None:
            stats["ff_proj"] = quant.amax(x)
        x = copy_to_model(x, self.tp)
        val, gate = quant.linear_maybe_q(self.net[0].proj, x).chunk(2, dim=-1)
        h = val * vnn.gelu(gate)
        if stats is not None:
            stats["ff_g"] = max_over_model(quant.amax(h), self.tp)
        return quant.linear_maybe_q(self.net[2], h, tp=self.tp)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_attention_blocks: int,
                 max_len: int, pe: str = "ape"):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_heads, max_len, pe)
            for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(num_attention_blocks))
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        for i, (norm, attn) in enumerate(zip(self.norms, self.attention_blocks)):
            ast = None
            if stats is not None:
                ast = stats.setdefault("attn", {})[str(i)] = {}
            x = x + attn(vnn.layer_norm(x, norm.weight, norm.bias, 1e-5), ast)
        return x + self.ff(vnn.layer_norm(x, self.ff_norm.weight,
                                          self.ff_norm.bias, 1e-5), stats)


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_transformer_block: int,
                 num_attention_blocks: int, max_len: int, pe: str = "ape"):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(dim, num_heads, num_attention_blocks, max_len, pe)
            for _ in range(num_transformer_block))
        self.proj_out = nn.Linear(dim, dim)
        nn.init.zeros_(self.proj_out.weight)   # zero_initialize
        nn.init.zeros_(self.proj_out.bias)


class TemporalModule(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, num_transformer_block: int = 1,
                 num_attention_blocks: int = 2, max_len: int = 32, pe: str = "ape"):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(
            dim, num_heads, num_transformer_block, num_attention_blocks, max_len, pe)

    def forward(self, x: torch.Tensor, b: int, t: int,
                stats: dict | None = None) -> torch.Tensor:
        """x: NHWC [B*T, H, W, C] -> same shape. With ``stats``, the
        module's activation absmaxes land there: {"proj_in", "blocks":
        {"0": {"attn": {"0": {"qkv", "out"}, ...}, "ff_proj", "ff_g"}},
        "proj_out"}."""
        tt = self.temporal_transformer
        bt, h, w, c = x.shape
        hw = h * w
        y = vnn.group_norm(x, tt.norm.weight, tt.norm.bias, 32, 1e-6)
        y = y.reshape(bt, hw, c)
        if stats is not None:
            stats["proj_in"] = quant.amax(y)
        y = quant.linear_maybe_q(tt.proj_in, y)
        y = y.reshape(b, t, hw, c).transpose(1, 2).reshape(b * hw, t, c)
        for i, blk in enumerate(tt.transformer_blocks):
            bst = None
            if stats is not None:
                bst = stats.setdefault("blocks", {})[str(i)] = {}
            y = blk(y, bst)
        y = y.reshape(b, hw, t, c).transpose(1, 2).reshape(bt, hw, c)
        if stats is not None:
            stats["proj_out"] = quant.amax(y)
        y = quant.linear_maybe_q(tt.proj_out, y)
        return y.reshape(bt, h, w, c) + x
