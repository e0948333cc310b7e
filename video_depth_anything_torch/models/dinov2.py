"""DINOv2 ViT encoder, NHWC in, ``[N, S, D]`` tokens out.

The port of the JAX package's ``models/dinov2.py``: patch 14,
LayerScale, exact-GELU MLP, no registers, pre-norm blocks with LayerNorm
eps 1e-6, and the +0.1 pos-embed interpolation offset. Attribute paths are
the original checkpoint's keys (``blocks.{i}.attn.qkv`` is one fused
Linear). Spatial attention runs kernel K1
(``kernels/spatial_attention.py``) on the fused projection's column views.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ViTConfig
from ..kernels.spatial_attention import spatial_attention
from ..ops import nn as vnn
from ..ops.resize import cubic_resize_matrix


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
    mh = cubic_resize_matrix(g, ph, scale=(ph + cfg.interpolate_offset) / g)
    mw = cubic_resize_matrix(g, pw, scale=(pw + cfg.interpolate_offset) / g)
    mh, mw = (torch.from_numpy(m.copy()).to(patch.device) for m in (mh, mw))
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
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        qkv = vnn.linear(x, self.qkv.weight, self.qkv.bias)  # [N, S, 3D]
        o = spatial_attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                              num_heads=self.num_heads,
                              scale=(d // self.num_heads) ** -0.5)
        return vnn.linear(o, self.proj.weight, self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = vnn.gelu(vnn.linear(x, self.fc1.weight, self.fc1.bias))
        return vnn.linear(h, self.fc2.weight, self.fc2.bias)


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
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = LayerScale(d, cfg.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(vnn.layer_norm(x, self.norm1.weight, self.norm1.bias, 1e-6))
        x = x + self.ls1.gamma.to(x.dtype) * y
        y = self.mlp(vnn.layer_norm(x, self.norm2.weight, self.norm2.bias, 1e-6))
        return x + self.ls2.gamma.to(x.dtype) * y


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.ffn_layer != "mlp":
            raise NotImplementedError(
                f"ffn_layer={cfg.ffn_layer!r} (vitg's fused SwiGLU) is not ported yet")
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
        tokens = self.embed_tokens(x)
        outs = []
        for i in range(max(taps) + 1):
            tokens = self.blocks[i](tokens)
            if i in taps:
                outs.append(tokens)
        results = []
        for o in outs:
            o = vnn.layer_norm(o, self.norm.weight, self.norm.bias, 1e-6)
            results.append((o[:, 1:, :], o[:, 0, :]))
        return results
