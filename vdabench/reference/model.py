"""Video Depth Anything in plain PyTorch, float32, NCHW: the benchmark's
reference forward.

Written from the published model (github.com/DepthAnything/
Video-Depth-Anything: ``video_depth_anything/dinov2.py``, ``dpt.py``,
``dpt_temporal.py``, ``motion_module/motion_module.py``,
``util/blocks.py``; the fused SwiGLU FFN of the ``vitg`` encoder from
github.com/facebookresearch/dinov2: ``dinov2/layers/swiglu_ffn.py``
``SwiGLUFFNFused``), with the original checkpoint's module names, so one
state dict with the keys ``pretrained.*`` and ``head.*`` loads into this
module and into the program alike. No kernel, cache or batching of the
program: attention is ``softmax(q k^T * scale) v`` in matmuls.

``operands(model, dtype)`` rounds the operands of every product to a
lower precision for the benchmark's control.

Departures from the published code, none of which changes the function:
the DINOv2 blocks keep no drop-path or register tokens (the released
models have none), and the output head runs in micro-batches of four
frames, as the published head does outside training.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

MICRO_BATCH = 4
# The dtype every product's operands are rounded to (``operands``); None:
# float32 throughout.
_LOW: dict = {"dtype": None}


def _round(x: torch.Tensor, dt) -> torch.Tensor:
    scale = torch.finfo(dt).max / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dt).to(x.dtype) / scale


class _Rounded(torch.autograd.Function):
    """Rounding in the forward and, of the gradient, in the backward."""

    @staticmethod
    def forward(ctx, x, dt):
        ctx.dt = dt
        return _round(x, dt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dt), None


def rounded(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the operand dtype of a control run, with one scale per
    tensor that maps its largest magnitude to the dtype's largest value
    (its gradient rounded alike); x itself otherwise."""
    dt = _LOW["dtype"]
    if dt is None:
        return x
    return _Rounded.apply(x, dt)


@contextlib.contextmanager
def operands(model: nn.Module, dtype: torch.dtype):
    """Within the block, every matrix product and convolution of ``model``
    reads its operands rounded to ``dtype`` (weights and activations, one
    scale per tensor; under a gradient the activations' gradients too) and
    accumulates in float32: the reference computed in a lower precision,
    the benchmark's control. Weights passed in by ``functional_call`` are
    the caller's to round (``rounded``)."""
    layers = [m for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv2d,
                                                            nn.ConvTranspose2d))]
    saved = [m.weight.data for m in layers]
    hooks = [m.register_forward_pre_hook(lambda _, args: (rounded(args[0]), *args[1:]))
             for m in layers]
    _LOW["dtype"] = dtype
    try:
        for m in layers:
            m.weight.data = _round(m.weight.data, dtype)
        yield
    finally:
        _LOW["dtype"] = None
        for m, w in zip(layers, saved):
            m.weight.data = w
        for h in hooks:
            h.remove()


# ----------------------------------------------------------------- DINOv2


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (c // self.heads) ** -0.5, qkv[1], qkv[2]
        attn = (rounded(q) @ rounded(k).transpose(-2, -1)).softmax(dim=-1)
        return self.proj((rounded(attn) @ rounded(v)).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    """DINOv2's fused SwiGLU FFN (``ffn_layer="swiglufused"``, the vitg
    encoder's): ``w12`` to twice the hidden size, ``silu(x1) * x2``, ``w3``
    back. The hidden size is 2/3 of the MLP's, rounded up to a multiple of
    8 (4096 at width 1536)."""

    def __init__(self, dim: int, mlp_hidden: int):
        super().__init__()
        hidden = (int(mlp_hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


# The encoder blocks' FFN, by the configuration's ``ffn_layer``.
FFN_LAYERS = {"mlp": Mlp, "swiglufused": SwiGLUFFNFused}


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, ffn_layer: str = "mlp"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if ffn_layer not in FFN_LAYERS:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}: {sorted(FFN_LAYERS)}")
        self.mlp = FFN_LAYERS[ffn_layer](dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, p = cfg["embed_dim"], cfg["patch_size"]
        n = (cfg["img_size"] // p) ** 2
        self.patch = p
        self.offset = cfg.get("interpolate_offset", 0.1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(d, p)
        ffn = cfg.get("ffn_layer", "mlp")
        self.blocks = nn.ModuleList(Block(d, cfg["num_heads"], cfg["mlp_ratio"], ffn)
                                    for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def interpolate_pos_encoding(self, h: int, w: int):
        """DINOv2's bicubic resample of the position table to an (h / 14,
        w / 14) grid, with its +0.1 offset in the scale factors."""
        pos = self.pos_embed.float()
        n, dim = pos.shape[1] - 1, pos.shape[2]
        h0, w0 = h // self.patch, w // self.patch
        if h0 * w0 == n and h0 == w0:
            return pos
        m = int(math.sqrt(n))
        grid = pos[:, 1:].reshape(1, m, m, dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, mode="bicubic",
                             scale_factor=((h0 + self.offset) / m, (w0 + self.offset) / m))
        assert grid.shape[-2:] == (h0, w0), grid.shape
        return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)

    def get_intermediate_layers(self, x, taps):
        """x [N, 3, H, W] -> per tap (patch tokens [N, P, D], cls [N, D]),
        after the final norm."""
        n, _, h, w = x.shape
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(n, -1, -1), t], dim=1)
        t = t + self.interpolate_pos_encoding(h, w)
        outs = []
        for i, blk in enumerate(self.blocks[:max(taps) + 1]):
            t = blk(t)
            if i in taps:
                outs.append(t)
        outs = [self.norm(o) for o in outs]
        return [(o[:, 1:], o[:, 0]) for o in outs]


# ---------------------------------------------------------------- the head


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None, size=None):
        out = x if skip is None else x + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if size is None:
            out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            out = F.interpolate(out, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(out)


class Scratch(nn.Module):
    def __init__(self, out_channels, features: int):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, 1, 1), nn.ReLU())


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.zeros(1, max_len, dim))


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])
        self.pos_encoder = PositionalEncoding(dim, max_len)

    def forward(self, x):
        """x [pixels, frames, C] -> the same."""
        p, t, c = x.shape
        x = x + self.pos_encoder.pe[:, :t]
        dh = c // self.heads

        def split(y):
            return y.reshape(p, t, self.heads, dh).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        attn = (rounded(q * dh ** -0.5) @ rounded(k).transpose(-2, -1)).softmax(dim=-1)
        return self.to_out[0]((rounded(attn) @ rounded(v)).transpose(1, 2).reshape(p, t, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Dropout(0.0), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int, attention_blocks: int = 2):
        super().__init__()
        self.attention_blocks = nn.ModuleList(TemporalAttention(dim, heads, max_len)
                                              for _ in range(attention_blocks))
        self.norms = nn.ModuleList(nn.LayerNorm(dim) for _ in range(attention_blocks))
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim)

    def forward(self, x):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x)) + x
        return self.ff(self.ff_norm(x)) + x


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([TemporalTransformerBlock(dim, heads, max_len)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, frames: int):
        """x [B * T, C, H, W] -> the same: attention over the T frames of
        each pixel, plus the residual."""
        bt, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(bt, h * w, c)
        y = self.proj_in(y)
        b = bt // frames
        y = y.reshape(b, frames, h * w, c).transpose(1, 2).reshape(b * h * w, frames, c)
        for blk in self.transformer_blocks:
            y = blk(y)
        y = y.reshape(b, h * w, frames, c).transpose(1, 2).reshape(bt, h * w, c)
        y = self.proj_out(y).reshape(bt, h, w, c).permute(0, 3, 1, 2)
        return y + x


class TemporalModule(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(dim, heads, max_len)

    def forward(self, x, frames: int):
        return self.temporal_transformer(x, frames)


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, f, oc = cfg["embed_dim"], cfg["features"], cfg["out_channels"]
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(oc, f)
        heads, t = cfg["motion_heads"], cfg["num_frames"]
        self.motion_modules = nn.ModuleList(TemporalModule(c, heads, t)
                                            for c in (oc[2], oc[3], f, f))

    def forward(self, feats, ph: int, pw: int, frames: int):
        """feats: 4 x (patch tokens [B*T, P, D], cls) -> depth [B*T, 1,
        14 ph, 14 pw], ReLU'd by the output head."""
        layers = []
        for i, (x, _) in enumerate(feats):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], ph, pw)
            layers.append(self.resize_layers[i](self.projects[i](x)))
        l1, l2, l3, l4 = layers
        mm, sc = self.motion_modules, self.scratch
        l3 = mm[0](l3, frames)
        l4 = mm[1](l4, frames)
        r1, r2, r3, r4 = sc.layer1_rn(l1), sc.layer2_rn(l2), sc.layer3_rn(l3), sc.layer4_rn(l4)
        path_4 = mm[2](sc.refinenet4(r4, size=r3.shape[2:]), frames)
        path_3 = mm[3](sc.refinenet3(path_4, r3, size=r2.shape[2:]), frames)
        out = []
        for i in range(0, r1.shape[0], MICRO_BATCH):
            s = slice(i, i + MICRO_BATCH)
            path_2 = sc.refinenet2(path_3[s], r2[s], size=r1.shape[2:])
            path_1 = sc.refinenet1(path_2, r1[s])
            y = F.interpolate(sc.output_conv1(path_1), (14 * ph, 14 * pw), mode="bilinear",
                              align_corners=True)
            out.append(sc.output_conv2(y))
        return torch.cat(out)


class VideoDepthAnything(nn.Module):
    """``pretrained`` (DINOv2) and ``head`` (the DPT head with its four
    motion modules), configured by a configuration file's dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.taps = list(cfg["taps"])
        self.patch = cfg["patch_size"]
        self.pretrained = DinoVisionTransformer(cfg)
        self.head = DPTHeadTemporal(cfg)

    def encode(self, x):
        """Normalised frames [N, 3, H, W] -> the four taps."""
        return self.pretrained.get_intermediate_layers(x, self.taps)

    def decode(self, feats, h: int, w: int, frames: int):
        """The taps of B windows of ``frames`` frames at network size (h, w)
        -> depth [B * frames, h, w], ReLU'd (the published ``forward`` after
        the encoder)."""
        depth = self.head(feats, h // self.patch, w // self.patch, frames)
        depth = F.interpolate(depth, size=(h, w), mode="bilinear", align_corners=True)
        return F.relu(depth)[:, 0]

    def forward(self, x):
        """x [B, T, 3, H, W] normalised -> depth [B, T, H, W]."""
        b, t, _, h, w = x.shape
        return self.decode(self.encode(x.flatten(0, 1)), h, w, t).unflatten(0, (b, t))
