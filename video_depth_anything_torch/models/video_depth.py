"""VideoDepthAnything: DINOv2 encoder + DPT-temporal head.

The port of the JAX package's ``models/video_depth.py``: flatten
(B, T) into the batch, take the encoder's 4 intermediate taps, decode with
the DPT-temporal head (temporal motion modules on layer_3, layer_4, path_4
and path_3), resize to the input size (bilinear, align corners) and ReLU.
Module attribute paths are the original checkpoint's keys, so a reference
``.pth`` (or ``convert.state_dict_from_params``'s output) loads with
``strict=True``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import nn as vnn
from ..ops.resize import resize_bilinear_align_corners
from .dinov2 import DinoVisionTransformer
from .dpt import Scratch
from .motion import TemporalModule


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, f, oc = cfg.vit.embed_dim, cfg.features, list(cfg.out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(oc, f)
        mkw = dict(num_heads=cfg.num_attention_heads,
                   num_transformer_block=cfg.num_transformer_block,
                   num_attention_blocks=cfg.num_attention_blocks,
                   max_len=cfg.num_frames)
        self.motion_modules = nn.ModuleList(
            TemporalModule(c, **mkw) for c in (oc[2], oc[3], f, f))

    def forward(self, feats, ph: int, pw: int, b: int, t: int,
                stats: dict | None = None) -> torch.Tensor:
        """feats: 4 x (patch tokens [B*T, P, D], cls [B*T, D]) ->
        depth [B*T, 14*ph, 14*pw, 1] fp32. With ``stats``, each motion
        module's calibration tree lands there under "0".."3"."""
        l1, l2, l3, l4 = self.refine_inputs(feats, ph, pw, b, t, stats)
        sc = self.scratch
        path_4 = self.tmod(2, sc.refinenet4(l4, size=l3.shape[1:3]), b, t, stats)
        path_3 = self.tmod(3, sc.refinenet3(path_4, l3, size=l2.shape[1:3]), b, t, stats)
        path_2 = sc.refinenet2(path_3, l2, size=l1.shape[1:3])
        path_1 = sc.refinenet1(path_2, l1)
        return sc.output_head(path_1, (14 * ph, 14 * pw))

    def tmod(self, i: int, feat: torch.Tensor, b: int, t: int,
             stats: dict | None = None) -> torch.Tensor:
        """Motion module i; with ``stats``, its calibration tree lands
        there under str(i)."""
        st = None
        if stats is not None:
            st = stats[str(i)] = {}
        return self.motion_modules[i](feat, b, t, st)

    def refine_inputs(self, feats, ph: int, pw: int, b: int, t: int,
                      stats: dict | None = None):
        """The taps projected, resized, through motion modules 0 and 1 and
        the 3x3 scratch convs: the RefineNet cascade's inputs l1..l4 (NHWC,
        ``features`` channels, 4x, 2x, 1x and 1/2x the patch grid)."""
        n, _, d = feats[0][0].shape
        g = [x.reshape(n, ph, pw, d) for x, _ in feats]
        pj, rl = self.projects, self.resize_layers

        def project(i):
            return vnn.conv2d(g[i], pj[i].weight, pj[i].bias)

        layer_1 = vnn.conv_transpose2d(project(0), rl[0].weight, rl[0].bias, 4)
        layer_2 = vnn.conv_transpose2d(project(1), rl[1].weight, rl[1].bias, 2)
        layer_3 = project(2)
        layer_4 = vnn.conv2d(project(3), rl[3].weight, rl[3].bias, stride=2,
                             padding=1)

        layer_3 = self.tmod(0, layer_3, b, t, stats)
        layer_4 = self.tmod(1, layer_4, b, t, stats)
        return self.scratch.rn([layer_1, layer_2, layer_3, layer_4])


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        for flag in ("use_bn", "use_clstoken"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag}=True heads are not ported yet")
        if cfg.pe != "ape":
            raise NotImplementedError(f"temporal pe={cfg.pe!r} is not ported yet")
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg.vit)
        self.head = DPTHeadTemporal(cfg)

    def encode(self, frames: torch.Tensor):
        """Normalised frames [N, H, W, 3] -> the 4 tap features."""
        return self.pretrained.get_intermediate_layers(
            frames, self.cfg.intermediate_layer_idx)

    def calibrate_stats(self, x: torch.Tensor) -> dict:
        """One int8-calibration forward (the float path) over x [B, T, H, W,
        3] normalised: {"encoder": {site: [L'] fp32}, "motion": {"0".."3":
        module trees}} of 0-d and [L'] fp32 tensors, the JAX package's tree.
        Feed it to ``ops.quant.quantize_model``."""
        b, t, h, w, _ = x.shape
        p = self.cfg.vit.patch_size
        feats, enc = self.pretrained.calibrate(x.reshape(b * t, h, w, 3),
                                               self.cfg.intermediate_layer_idx)
        motion: dict = {}
        self.head(feats, h // p, w // p, b, t, stats=motion)
        return {"encoder": enc, "motion": motion}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, H, W, 3] normalised -> depth [B, T, H, W] fp32, ReLU'd."""
        b, t, h, w, _ = x.shape
        p = self.cfg.vit.patch_size
        feats = self.encode(x.reshape(b * t, h, w, 3))
        depth = self.head(feats, h // p, w // p, b, t)
        depth = resize_bilinear_align_corners(depth.float(), (h, w))
        return torch.relu(depth)[..., 0].reshape(b, t, h, w)


@torch.no_grad()
def init_random(model: VideoDepthAnything, seed: int = 0) -> VideoDepthAnything:
    """Seeded random weights, drawn on each parameter's own device.

    Encoder linears and the pos embed: truncated normal (std 0.02, cut at
    2 std); patch embed: truncated normal (std sqrt(1/fan_in)); head convs
    and linears: torch's default uniform bounds; norms 1/0; LayerScale at
    init_values; proj_out zero (zero_initialize). Then proj_out and
    cls_token get 0.02 * N(0, 1) added, so the temporal
    modules do real work — as the parity tests of the JAX package do with
    the reference model.
    """
    gens: dict = {}

    def gen(t):
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(seed)
        return gens[t.device]

    def trunc(t, std):
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen(t))

    def uniform(t, bound):
        nn.init.uniform_(t, -bound, bound, generator=gen(t))

    for name, m in model.named_modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            if name.startswith("pretrained."):
                trunc(w, 0.02 if isinstance(m, nn.Linear) else math.sqrt(1.0 / fan_in))
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            else:
                bound = math.sqrt(1.0 / fan_in)
                uniform(w, bound * math.sqrt(3))
                if m.bias is not None:
                    uniform(m.bias, bound)
            if name.endswith("proj_out"):
                nn.init.zeros_(w)
                nn.init.zeros_(m.bias)
    enc = model.pretrained
    trunc(enc.pos_embed, 0.02)
    enc.cls_token.copy_(1e-6 * torch.randn(enc.cls_token.shape, generator=gen(enc.cls_token),
                                           device=enc.cls_token.device))
    nn.init.zeros_(enc.mask_token)
    for blk in enc.blocks:
        nn.init.constant_(blk.ls1.gamma, enc.cfg.init_values)
        nn.init.constant_(blk.ls2.gamma, enc.cfg.init_values)
    for name, p in model.named_parameters():
        if "proj_out" in name or "cls_token" in name:
            p.add_(0.02 * torch.randn(p.shape, generator=gen(p), device=p.device,
                                      dtype=p.dtype))
    return model


def build_model(cfg: ModelConfig, seed: int | None = None,
                device: str | torch.device = "cpu") -> VideoDepthAnything:
    """A VideoDepthAnything in eval mode on ``device``; random weights from
    ``seed`` (perturbed as ``init_random`` describes) when one is given."""
    with torch.device(device):
        model = VideoDepthAnything(cfg)
    if seed is not None:
        init_random(model, seed)
    return model.eval().requires_grad_(False)
