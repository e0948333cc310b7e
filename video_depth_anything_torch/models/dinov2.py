"""DINOv2 ViT encoder, NHWC in, ``[N, S, D]`` tokens out.

The port of the JAX package's ``models/dinov2.py``: patch 14,
LayerScale, exact-GELU MLP (vitg: the fused SwiGLU FFN), no registers,
pre-norm blocks with LayerNorm eps 1e-6, and the +0.1 pos-embed
interpolation offset. Attribute paths are the original checkpoint's keys
(``blocks.{i}.attn.qkv`` is one fused Linear). Spatial attention runs
kernel K1 (``kernels/spatial_attention.py``) on the fused projection's
column views; a head dim other than 64 goes on from there to K4, as in
the JAX package.

int8 mode (``ops/quant.py::quantize_encoder``): the fused qkv, proj, fc1
and fc2 (SwiGLU: w12 and w3) become ``QLinear`` sites, and q and k are
re-quantized for kernel K3 (``kernels/spatial_attention_qk8.py``), which
reads v in place. A ``stats`` dict passed down the forward collects the
calibration absmaxes (``calibrate``).

On the mesh's model axis (``parallel/mesh.py::split_params``) an
attention or FFN block holds its rank's shard and ``tp``, its
``ModelAxis``: the attention runs its local heads (q, k and v of those
heads are its qkv shard's three parts), the FFN its part of the hidden;
the row-split product (proj, fc2, w3) is summed over the group in fp32
before its bias is added and it is rounded, once. The absmaxes of split activations are a MAX over the
group.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..config import ViTConfig
from ..kernels.spatial_attention import spatial_attention
from ..kernels.spatial_attention_qk8 import spatial_attention_qk8
from ..ops import nn as vnn
from ..ops import quant
from ..ops.resize import device_matrix
from ..parallel.tensor import copy_to_model, max_over_model


def interpolate_pos_encoding(pos_embed: torch.Tensor, ph: int, pw: int,
                             cfg: ViTConfig) -> torch.Tensor:
    """Resample pos_embed [1, 1+N, D] to a (ph, pw) patch grid in fp32:
    bicubic with scale factor (grid + interpolate_offset) / sqrt(N)."""
    n = pos_embed.shape[1] - 1
    if ph * pw == n and ph == pw:
        return pos_embed
    g = int(math.sqrt(n))
    if g * g != n:
        raise ValueError(f"pos_embed patches {n} not square")
    dim = pos_embed.shape[-1]
    cls_pos = pos_embed[:, :1].float()
    patch = pos_embed[:, 1:].float().reshape(g, g, dim)
    mh = device_matrix("cubic", g, ph, (ph + cfg.interpolate_offset) / g, patch.device,
                       torch.float32)
    mw = device_matrix("cubic", g, pw, (pw + cfg.interpolate_offset) / g, patch.device,
                       torch.float32)
    patch = torch.einsum("oh,hwd->owd", mh, patch)
    patch = torch.einsum("pw,owd->opd", mw, patch)
    return torch.cat([cls_pos, patch.reshape(1, ph * pw, dim)], dim=1)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads     # this rank's heads once split
        self.tp = None                 # the ModelAxis once split
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        # Static absmaxes of the q and k projection outputs (int8 mode only).
        self.register_buffer("q_amax", None)
        self.register_buffer("k_amax", None)

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        x = copy_to_model(x, self.tp)
        qkv = quant.linear_maybe_q(self.qkv, x)  # [N, S, 3D] (split: this rank's heads)
        d = qkv.shape[-1] // 3
        dh = d // self.num_heads
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        if stats is not None:
            stats["q_out"] = max_over_model(quant.amax(q), self.tp)
            stats["k_out"] = max_over_model(quant.amax(k), self.tp)
        if self.q_amax is not None:
            scales = torch.stack([self.q_amax.float() * (dh ** -0.5 / 127.0),
                                  self.k_amax.float() / 127.0])
            o = spatial_attention_qk8(quant.quant_act(q, self.q_amax),
                                      quant.quant_act(k, self.k_amax), v, scales,
                                      num_heads=self.num_heads)
        else:
            o = spatial_attention(q, k, v, num_heads=self.num_heads, scale=dh ** -0.5)
        if stats is not None:
            stats["proj"] = max_over_model(quant.amax(o), self.tp)
        return quant.linear_maybe_q(self.proj, o, tp=self.tp)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.tp = None
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        h = vnn.gelu(quant.linear_maybe_q(self.fc1, copy_to_model(x, self.tp)))
        if stats is not None:
            stats["fc2"] = max_over_model(quant.amax(h), self.tp)
        return quant.linear_maybe_q(self.fc2, h, tp=self.tp)


def swiglu_hidden(dim: int, mlp_ratio: float) -> int:
    """The fused SwiGLU's hidden size: 2/3 of the MLP's, rounded up to a
    multiple of 8 (4096 for vitg)."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


class SwiGLUFFNFused(nn.Module):
    """vitg's FFN: w12 -> split -> silu(x1) * x2 -> w3, as the JAX package's
    ``_ffn``. The split, silu and the product each round in the activation
    dtype."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.tp = None
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        x1, x2 = quant.linear_maybe_q(self.w12, copy_to_model(x, self.tp)).chunk(2, dim=-1)
        h = F.silu(x1) * x2
        if stats is not None:   # the w3 input's absmax, in the "fc2" slot
            stats["fc2"] = max_over_model(quant.amax(h), self.tp)
        return quant.linear_maybe_q(self.w3, h, tp=self.tp)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_values))


class Block(nn.Module):
    """Pre-norm ViT block with LayerScale."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d, cfg.num_heads)
        self.ls1 = LayerScale(d, cfg.init_values)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        if cfg.ffn_layer == "mlp":
            self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        elif cfg.ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFNFused(d, swiglu_hidden(d, cfg.mlp_ratio))
        else:
            raise ValueError(f"unknown ffn_layer {cfg.ffn_layer!r}")
        self.ls2 = LayerScale(d, cfg.init_values)

    def forward(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        """One block; with ``stats``, the block's activation absmaxes land
        there under the ``quant.ACT_SITES`` names."""
        y = vnn.layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-6)
        if stats is not None:
            stats["qkv"] = quant.amax(y)
        x = x + self.ls1.gamma.to(x.dtype) * self.attn(y, stats)
        y = vnn.layer_norm(x, self.norm2.weight, self.norm2.bias, 1e-6)
        if stats is not None:   # the FFN's input (fc1, or SwiGLU's w12)
            stats["fc1"] = quant.amax(y)
        return x + self.ls2.gamma.to(x.dtype) * self.mlp(y, stats)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.num_register_tokens:
            raise NotImplementedError("register tokens are not ported")
        self.cfg = cfg
        d = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Patch embed + cls token + interpolated pos embed."""
        n, h, w, _ = x.shape
        p = self.cfg.patch_size
        ph, pw = h // p, w // p
        proj = self.patch_embed.proj
        tokens = vnn.conv2d(x, proj.weight, proj.bias, stride=p)
        tokens = tokens.reshape(n, ph * pw, self.cfg.embed_dim)
        cls = self.cls_token.to(tokens.dtype).expand(n, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = interpolate_pos_encoding(self.pos_embed, ph, pw, self.cfg)
        return tokens + pos.to(tokens.dtype)

    def get_intermediate_layers(self, x: torch.Tensor, taps
                                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """x: [N, H, W, 3] (H, W multiples of the patch) -> per tap
        (patch tokens [N, P, D], cls [N, D]) after the final norm. Blocks
        after the last tap do not run."""
        return self._run(x, taps, None)

    def calibrate(self, x: torch.Tensor, taps):
        """One calibration forward: (the taps exactly as
        ``get_intermediate_layers`` returns them, {site: [L'] fp32 absmax})
        with L' = last tap + 1 blocks run. Feed the stats to
        ``quant.quantize_encoder``."""
        per_block: list[dict] = []
        results = self._run(x, taps, per_block)
        stats = {k: torch.stack([st[k] for st in per_block]) for k in per_block[0]}
        return results, stats

    def _run(self, x, taps, per_block):
        tokens = self.embed_tokens(x)
        outs = []
        for i in range(max(taps) + 1):
            st = None if per_block is None else {}
            tokens = self.blocks[i](tokens, st)
            if per_block is not None:
                per_block.append(st)
            outs.extend(tokens for t in taps if t == i)
        results = []
        for o in outs:
            o = vnn.layer_norm(o, self.norm.weight, self.norm.bias, 1e-6)
            results.append((o[:, 1:, :], o[:, 0, :]))
        return results
