"""VideoDepthAnything: DINOv2 encoder + DPT-temporal head.

The port of the JAX package's ``models/video_depth.py``: flatten
(B, T) into the batch, take the encoder's 4 intermediate taps, decode with
the DPT-temporal head (temporal motion modules on layer_3, layer_4, path_4
and path_3; the ``use_clstoken`` readout, ``use_bn`` and ``pe="rope"``
variants as in the JAX package), resize to the input size (bilinear,
align corners) and ReLU.
Module attribute paths are the original checkpoint's keys, so a reference
``.pth`` (or ``convert.state_dict_from_params``'s output) loads with
``strict=True``.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops import nn as vnn
from ..ops.resize import resize_bilinear_align_corners
from ..utils import profiling
from .dinov2 import DinoVisionTransformer
from .dpt import Scratch
from .motion import TemporalModule, sinusoidal_pe


_MOTION_SPANS = tuple(f"vda.head.motion{i}" for i in range(4))


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, f, oc = cfg.vit.embed_dim, cfg.features, list(cfg.out_channels)
        self.use_clstoken = cfg.use_clstoken
        if cfg.use_clstoken:
            self.readout_projects = nn.ModuleList(
                nn.Sequential(nn.Linear(2 * d, d), nn.GELU()) for _ in oc)
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(oc, f, cfg.use_bn)
        mkw = dict(num_heads=cfg.num_attention_heads,
                   num_transformer_block=cfg.num_transformer_block,
                   num_attention_blocks=cfg.num_attention_blocks,
                   max_len=cfg.num_frames, pe=cfg.pe)
        self.motion_modules = nn.ModuleList(
            TemporalModule(c, **mkw) for c in (oc[2], oc[3], f, f))

    def forward(self, feats, ph: int, pw: int, b: int, t: int,
                stats: dict | None = None, train: bool = False) -> torch.Tensor:
        """feats: 4 x (patch tokens [B*T, P, D], cls [B*T, D]) ->
        depth [B*T, 14*ph, 14*pw, 1] fp32. With ``stats``, each motion
        module's calibration tree lands there under "0".."3". ``train``:
        the output head's full fp32 island (``Scratch.output_head``). The
        span ``vda.head`` (device time on a card), its stages ``vda.head.*``;
        ``vda.head.output`` counts ``fused``, the calls whose tail ran K7."""
        with profiling.span("vda.head", device=feats[0][0].is_cuda):
            layers = self.refine_inputs(feats, ph, pw, b, t, stats)
            path_1 = self.cascade(layers, lambda i, path: self.tmod(i, path, b, t, stats))
            out_hw = (14 * ph, 14 * pw)
            with profiling.span("vda.head.output") as sp:
                sp.add(fused=int(self.scratch.fused_tail(path_1, out_hw, train)))
                return self.scratch.output_head(path_1, out_hw, train=train)

    def cascade(self, layers, between) -> torch.Tensor:
        """The RefineNet cascade refinenet4 -> refinenet1 on l1..l4 ->
        path_1; ``between(i, path)`` runs after refinenet4 (i = 2) and
        refinenet3 (i = 3): the forward puts motion modules 2 and 3 there."""
        l1, l2, l3, l4 = layers
        sc = self.scratch
        with profiling.span("vda.head.refinenet4"):
            path_4 = sc.refinenet4(l4, size=l3.shape[1:3])
        path_4 = between(2, path_4)
        with profiling.span("vda.head.refinenet3"):
            path_3 = sc.refinenet3(path_4, l3, size=l2.shape[1:3])
        path_3 = between(3, path_3)
        with profiling.span("vda.head.refinenet2"):
            path_2 = sc.refinenet2(path_3, l2, size=l1.shape[1:3])
        with profiling.span("vda.head.refinenet1"):
            return sc.refinenet1(path_2, l1)

    def tmod(self, i: int, feat: torch.Tensor, b: int, t: int,
             stats: dict | None = None) -> torch.Tensor:
        """Motion module i; with ``stats``, its calibration tree lands
        there under str(i)."""
        st = None
        if stats is not None:
            st = stats[str(i)] = {}
        with profiling.span(_MOTION_SPANS[i]):
            return self.motion_modules[i](feat, b, t, st)

    def refine_inputs(self, feats, ph: int, pw: int, b: int, t: int,
                      stats: dict | None = None):
        """The taps projected, resized, through motion modules 0 and 1 and
        the 3x3 scratch convs: the RefineNet cascade's inputs l1..l4 (NHWC,
        ``features`` channels, 4x, 2x, 1x and 1/2x the patch grid)."""
        with profiling.span("vda.head.project"):
            layer_1, layer_2, layer_3, layer_4 = self.project(self.grids(feats, ph, pw))
        layer_3 = self.tmod(0, layer_3, b, t, stats)
        layer_4 = self.tmod(1, layer_4, b, t, stats)
        with profiling.span("vda.head.rn"):
            return self.scratch.rn([layer_1, layer_2, layer_3, layer_4])

    def grids(self, feats, ph: int, pw: int):
        """The taps as [N, ph, pw, D] grids (after the ``use_clstoken``
        readout)."""
        n, _, d = feats[0][0].shape
        if self.use_clstoken:   # readout: linear + GELU on [patch, cls]
            g = []
            for (x, cls), ro in zip(feats, self.readout_projects):
                y = torch.cat([x, cls[:, None, :].expand(x.shape)], dim=-1)
                y = vnn.gelu(vnn.linear(y, ro[0].weight, ro[0].bias))
                g.append(y.reshape(n, ph, pw, d))
        else:
            g = [x.reshape(n, ph, pw, d) for x, _ in feats]
        return g

    def project(self, g):
        """The 1x1 projections and resize layers of the 4 grids: layer_1..4
        at 4x, 2x, 1x and 1/2x the patch grid, before the motion modules."""
        pj, rl = self.projects, self.resize_layers

        def project(i):
            return vnn.conv2d(g[i], pj[i].weight, pj[i].bias)

        layer_1 = vnn.conv_transpose2d(project(0), rl[0].weight, rl[0].bias, 4)
        layer_2 = vnn.conv_transpose2d(project(1), rl[1].weight, rl[1].bias, 2)
        layer_3 = project(2)
        layer_4 = vnn.conv2d(project(3), rl[3].weight, rl[3].bias, stride=2,
                             padding=1)
        return layer_1, layer_2, layer_3, layer_4


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: [B, T, H, W, 3] normalised -> depth [B, T, H, W] fp32, ReLU'd.
        ``train``: the JAX package's ``forward(train=True)`` (the output
        head's full fp32 island)."""
        b, t, h, w, _ = x.shape
        p = self.cfg.vit.patch_size
        feats = self.encode(x.reshape(b * t, h, w, 3))
        return finish(self.head(feats, h // p, w // p, b, t, train=train), b, t, h, w)


def finish(depth: torch.Tensor, b: int, t: int, h: int, w: int) -> torch.Tensor:
    """The head's [B*T, h', w', 1] depth -> [B, T, H, W] fp32: resized to
    the input size (bilinear, align corners), then ReLU'd."""
    depth = resize_bilinear_align_corners(depth.float(), (h, w))
    return vnn.relu(depth)[..., 0].reshape(b, t, h, w)


@torch.no_grad()
def init_random(model: VideoDepthAnything, seed: int = 0) -> VideoDepthAnything:
    """Seeded random weights, drawn on each parameter's own device.

    Encoder linears and the pos embed: truncated normal (std 0.02, cut at
    2 std); patch embed: truncated normal (std sqrt(1/fan_in)); head convs
    and linears: torch's default uniform bounds; norms 1/0; LayerScale at
    init_values; proj_out zero (zero_initialize). Then proj_out and
    cls_token get 0.02 * N(0, 1) added, so the temporal
    modules do real work — as the parity tests of the JAX package do with
    the reference model. BatchNorm (``use_bn``): weight 1 + 0.1 N, bias
    and running mean 0.1 N, running var 1 + 0.5 U(0, 1), so that it is no
    identity. Everything is drawn on the parameters' device (vitg's 1.13 B
    parameters never pass through the host).
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
        elif isinstance(m, nn.BatchNorm2d):
            for t, base, f in ((m.weight, 1.0, 0.1), (m.bias, 0.0, 0.1),
                               (m.running_mean, 0.0, 0.1)):
                t.copy_(base + f * torch.randn(t.shape, generator=gen(t), device=t.device))
            m.running_var.copy_(1.0 + 0.5 * torch.rand(m.running_var.shape,
                                                       generator=gen(m.running_var),
                                                       device=m.running_var.device))
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


def numpy_state_dict(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights that every machine draws alike: the model's
    ``state_dict()``, in its key order, from one
    ``np.random.default_rng(seed)``, fp32 host arrays.

    ``init_random``'s rules, drawn with numpy: encoder linears and the pos
    embed truncated normal (std 0.02, cut at 2 std, out-of-range draws
    redrawn), the patch embed truncated normal (std sqrt(1/fan_in)), head
    convs and linears uniform at torch's default bounds, norms 1/0,
    LayerScale at init_values, the APE tables sinusoidal; proj_out is 0.02
    N(0, 1) (zero plus its perturbation), cls_token 1e-6 N + 0.02 N, and
    BatchNorm (``use_bn``) weight 1 + 0.1 N, bias and running mean 0.1 N,
    running var 1 + 0.5 U(0, 1). The dict loads with ``strict=True`` into
    the model, and its keys are the reference checkpoint's. Host memory
    only (about 1.5 GB for vitl): vitg stays on ``init_random``.
    """
    with torch.device("meta"):
        shapes = VideoDepthAnything(cfg)
    mods = dict(shapes.named_modules())
    rng = np.random.default_rng(seed)

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def trunc(shape, std):
        x = normal(shape)
        out = np.abs(x) > 2
        while out.any():
            x[out] = normal(int(out.sum()))
            out = np.abs(x) > 2
        return np.float32(std) * x

    def uniform(shape, bound):
        return np.float32(bound) * (2 * rng.random(shape, dtype=np.float32) - 1)

    sd = {}
    for key, t in shapes.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        m, shape = mods[prefix], tuple(t.shape)
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            v = np.full(shape, 1.0 if leaf == "weight" else 0.0, np.float32)
        elif isinstance(m, nn.BatchNorm2d):
            if leaf == "num_batches_tracked":
                v = np.zeros(shape, np.int64)
            elif leaf == "running_var":
                v = 1 + 0.5 * rng.random(shape, dtype=np.float32)
            else:
                v = np.float32(leaf == "weight") + np.float32(0.1) * normal(shape)
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight.shape
            fan_in = (w[1] * w[2] * w[3] if isinstance(m, nn.ConvTranspose2d)
                      else math.prod(w[1:]))
            if prefix.endswith("proj_out"):
                v = np.float32(0.02) * normal(shape)
            elif not key.startswith("pretrained."):
                bound = math.sqrt(1.0 / fan_in)
                v = uniform(shape, bound * math.sqrt(3) if leaf == "weight" else bound)
            elif leaf == "bias":
                v = np.zeros(shape, np.float32)
            else:
                v = trunc(shape, 0.02 if isinstance(m, nn.Linear) else math.sqrt(1.0 / fan_in))
        elif leaf == "pos_embed":
            v = trunc(shape, 0.02)
        elif leaf == "cls_token":
            v = np.float32(1e-6) * normal(shape)
            v += np.float32(0.02) * normal(shape)
        elif leaf == "mask_token":
            v = np.zeros(shape, np.float32)
        elif leaf == "gamma":
            v = np.full(shape, cfg.vit.init_values, np.float32)
        elif leaf == "pe":
            v = sinusoidal_pe(shape[2], shape[1])
        else:
            raise ValueError(f"numpy_state_dict: no rule for {key}")
        sd[key] = v if v.dtype == np.int64 else v.astype(np.float32, copy=False)
    return sd


def state_dict_sha256(sd: dict) -> str:
    """SHA-256 of a state dict's bytes (NumPy arrays or CPU tensors), in
    key order: two readings on it used the same weights."""
    h = hashlib.sha256()
    for v in sd.values():
        h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()


def load_numpy_state_dict(model: VideoDepthAnything, sd: dict) -> VideoDepthAnything:
    """``numpy_state_dict``'s arrays into ``model`` (on any device), strictly."""
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
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
