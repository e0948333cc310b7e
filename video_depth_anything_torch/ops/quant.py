"""int8 mode (``--int8``): w8a8 linears with static activation scales.

The port of the JAX package's ``ops/quant.py``. The encoder's six hot
matmuls per block (the fused ``attn.qkv``, ``attn.proj``, ``mlp.fc1``,
``mlp.fc2``; vitg's SwiGLU ``mlp.w12`` and ``mlp.w3``, calibrated in the
``fc1`` / ``fc2`` slots as the JAX package does) and every linear of the four motion modules take per
output channel int8 weights and a *static* per-tensor activation absmax
from a one-window calibration pass (``VideoDepthAnything.calibrate_stats``).
The q and k projection outputs are re-quantized too, so spatial attention
contracts int8 QK (kernel K3, ``kernels/spatial_attention_qk8.py``).
Everything else (patch embed, norms, LayerScale, the DPT convs, the output
island) keeps its float dtype.

The int8 product is ``torch._int_mm`` (int32 accumulation; cuBLASLt on the
card, ATen on the CPU), as the JAX package leaves its ``dot_general`` to
XLA. On the card it needs M > 16 and K, N multiples of 8; ``qlinear``
raises on any other shape rather than fall back to a float product. x goes
in row-major and the weight column-major (the transpose view of its
``[out, in]`` storage): on the H100 a row-major weight sends cuBLASLt to a
slower sm80 compatibility kernel for the same integers (PERF.md).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..parallel.tensor import reduce_from_model
from . import nn as vnn

# Activation-quantization sites per encoder block, in forward order. "qkv"
# is one shared site (the LN1 output feeding the fused qkv product);
# "q_out" / "k_out" are the q and k projection outputs that K3 takes int8.
ACT_SITES = ("qkv", "proj", "fc1", "fc2", "q_out", "k_out")


def amax(x: torch.Tensor) -> torch.Tensor:
    """Calibration primitive: fp32 absmax of a tensor (0-d)."""
    return x.float().abs().amax()


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [out, in] float -> (w_i8 [out, in] int8, ws [out] fp32).

    Symmetric per output channel: ws = absmax over the input dim / 127.
    """
    w32 = w.detach().float()
    ws = (w32.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    return torch.round(w32 / ws[:, None]).to(torch.int8), ws


def quant_act(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Quantize activations with a static absmax; values beyond it
    saturate. Multiplies by 127 / amax, rounds half to even, clips."""
    inv = 127.0 / amax.float().clamp_min(1e-12)
    return (x.float() * inv).round_().clamp_(-127, 127).to(torch.int8)


def _check_int_mm(m: int, k: int, n: int, device: torch.device) -> None:
    if device.type == "cuda" and not (m > 16 and k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"int8 product [{m}, {k}] x [{k}, {n}] on the card needs "
                         f"M > 16 and K, N multiples of 8")


def qlinear(x_i8: torch.Tensor, w_i8: torch.Tensor, ws: torch.Tensor,
            amax: torch.Tensor, bias: torch.Tensor | None,
            out_dtype: torch.dtype, tp=None) -> torch.Tensor:
    """int8 x_i8 [..., K] @ w_i8 [N, K]^T -> dequantized [..., N] out_dtype.

    int32 accumulation, then the fp32 rescale by the per-column weight
    scale times the per-tensor activation scale, the cast, and only then
    the bias add in out_dtype (the JAX package's order). ``tp``: the
    ``ModelAxis`` of a row-split site (K cut over the model group): the
    ranks' int32 partial sums are summed over the group before the
    rescale, exactly, so the site computes the unsplit site's bits.
    """
    n, k = w_i8.shape
    lead = x_i8.shape[:-1]
    x2 = x_i8.reshape(-1, k)
    _check_int_mm(x2.shape[0], k, n, x2.device)
    y = reduce_from_model(torch._int_mm(x2.contiguous(), w_i8.t()), tp)
    scale = ws.float() * (amax.float() / 127.0)
    y = torch.mul(y, scale).to(out_dtype)   # int32 * fp32, in fp32: one pass
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.reshape(*lead, n)


class QLinear(nn.Module):
    """An int8 linear site: ``w_i8`` [out, in] int8, ``ws`` [out] fp32,
    ``bias`` [out] in the float model's dtype (or None) and the site's
    activation ``amax`` (0-d fp32). Built from a float ``nn.Linear`` by
    ``from_linear``."""

    def __init__(self, w_i8: torch.Tensor, ws: torch.Tensor,
                 bias: torch.Tensor | None, amax: torch.Tensor):
        super().__init__()
        self.register_buffer("w_i8", w_i8)
        self.register_buffer("ws", ws)
        self.register_buffer("bias", bias)
        self.register_buffer("amax", amax)

    @classmethod
    def from_linear(cls, lin: nn.Linear, amax) -> "QLinear":
        w_i8, ws = quantize_weight(lin.weight)
        bias = None if lin.bias is None else lin.bias.detach().clone()
        a = _f32(amax).to(lin.weight.device).reshape(())
        return cls(w_i8, ws, bias, a)

    def forward(self, x: torch.Tensor, x_i8: torch.Tensor | None = None) -> torch.Tensor:
        if x_i8 is None:
            x_i8 = quant_act(x, self.amax)
        return qlinear(x_i8, self.w_i8, self.ws, self.amax, self.bias, x.dtype)


def linear_maybe_q(m: nn.Module, x: torch.Tensor, x_i8: torch.Tensor | None = None,
                   tp=None) -> torch.Tensor:
    """``vnn.linear`` through ``m``, or its int8 product when ``m`` is a
    QLinear. x_i8: an already-quantized input shared between sites (one
    LN output feeding to_q, to_k and to_v is quantized once). ``tp``: the
    ``ModelAxis`` of a row-split site (its input and weight cut on the
    contraction axis): each rank's product, left in fp32, is summed over
    the model group in fp32, the bias is added, once, and the result is
    rounded to x's dtype, once, as the unsplit product is; under int8 the
    sum is of the int32 partial sums (``qlinear``)."""
    if isinstance(m, QLinear):
        if tp is None:
            return m(x, x_i8)
        x_i8 = quant_act(x, m.amax) if x_i8 is None else x_i8
        return qlinear(x_i8, m.w_i8, m.ws, m.amax, m.bias, x.dtype, tp)
    if tp is None:
        return vnn.linear(x, m.weight, m.bias)
    y = reduce_from_model(vnn.linear_f32(x, m.weight), tp)
    return (y if m.bias is None else y + m.bias.to(x.dtype)).to(x.dtype)


def _f32(v) -> torch.Tensor:
    """A stat (tensor, NumPy array or float) as an fp32 tensor of its own."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _padded(v, depth: int) -> torch.Tensor:
    """Per-block stats [L'] padded with 1.0 to [depth] (blocks past the last
    tap never run)."""
    v = _f32(v).cpu().reshape(-1)
    if v.shape[0] < depth:
        v = torch.cat([v, torch.ones(depth - v.shape[0])])
    return v


@torch.no_grad()
def quantize_encoder(encoder: nn.Module, act_stats) -> nn.Module:
    """int8-quantize the blocks of a DinoVisionTransformer in place.

    act_stats: {site: [L'] absmax} from ``calibrate`` (L' = last tap + 1).
    Stats from a calibration tree without "q_out" / "k_out" leave the
    attention on K1 with float q and k, as in the JAX package.
    """
    depth = len(encoder.blocks)
    qs = {k: _padded(act_stats[k], depth) for k in ACT_SITES if k in act_stats}
    for i, blk in enumerate(encoder.blocks):
        attn, mlp = blk.attn, blk.mlp
        attn.qkv = QLinear.from_linear(attn.qkv, qs["qkv"][i])
        attn.proj = QLinear.from_linear(attn.proj, qs["proj"][i])
        if hasattr(mlp, "w12"):   # vitg's SwiGLU: the fc1 / fc2 slots are w12's and w3's
            mlp.w12 = QLinear.from_linear(mlp.w12, qs["fc1"][i])
            mlp.w3 = QLinear.from_linear(mlp.w3, qs["fc2"][i])
        else:
            mlp.fc1 = QLinear.from_linear(mlp.fc1, qs["fc1"][i])
            mlp.fc2 = QLinear.from_linear(mlp.fc2, qs["fc2"][i])
        if "q_out" in qs:
            dev = attn.qkv.amax.device
            attn.q_amax = qs["q_out"][i].to(dev)
            attn.k_amax = qs["k_out"][i].to(dev)
    return encoder


@torch.no_grad()
def quantize_motion_module(mod: nn.Module, stats) -> nn.Module:
    """int8-quantize one TemporalModule in place — proj_in, each attention
    block's to_q / to_k / to_v (one shared input scale) and to_out, the
    GEGLU proj and output linear, proj_out — from the stats tree its
    ``forward(..., stats=)`` filled."""
    tt = mod.temporal_transformer
    for i, blk in enumerate(tt.transformer_blocks):
        bst = stats["blocks"][str(i)]
        for j, attn in enumerate(blk.attention_blocks):
            ast = bst["attn"][str(j)]
            for name in ("to_q", "to_k", "to_v"):
                setattr(attn, name, QLinear.from_linear(getattr(attn, name), ast["qkv"]))
            attn.to_out[0] = QLinear.from_linear(attn.to_out[0], ast["out"])
        net = blk.ff.net
        net[0].proj = QLinear.from_linear(net[0].proj, bst["ff_proj"])
        net[2] = QLinear.from_linear(net[2], bst["ff_g"])
    tt.proj_in = QLinear.from_linear(tt.proj_in, stats["proj_in"])
    tt.proj_out = QLinear.from_linear(tt.proj_out, stats["proj_out"])
    return mod


def quantize_model(model: nn.Module, stats) -> nn.Module:
    """A copy of a VideoDepthAnything with the encoder blocks and the four
    motion modules in int8; ``stats`` is ``calibrate_stats``'s tree (or the
    JAX package's: same keys and shapes). Quantize after casting the float
    model to its working dtype, as the JAX pipeline does: the weight scales
    come from the cast weights, the biases keep that dtype."""
    q = copy.deepcopy(model)
    quantize_encoder(q.pretrained, stats["encoder"])
    for k, mod in enumerate(q.head.motion_modules):
        quantize_motion_module(mod, stats["motion"][str(k)])
    return q.eval().requires_grad_(False)
