"""Seeded weights on the device, as one state dict with the original
checkpoint's keys (``pretrained.*``, ``head.*``).

The keys and shapes are the reference model's (``reference/model.py``,
built on the meta device). Every value is drawn with one ``torch.Generator``
on the device in two calls (one normal, one uniform draw over all tensors
that take one) in the served dtype, then scaled per tensor:

- encoder linears, ``pos_embed`` and ``cls_token``: normal, std 0.02;
  the patch embedding: normal, std sqrt(1 / fan_in); encoder biases 0;
- head convolutions and linears: uniform at torch's default bounds
  (weights +-sqrt(3 / fan_in), biases +-sqrt(1 / fan_in));
- every norm 1 and 0, LayerScale 1, ``mask_token`` 0, the motion
  modules' position tables sinusoidal;
- each motion module's zero-initialised ``proj_out``: normal, std 0.02, so
  that the temporal modules do work;
- the last convolution's bias raised by ``OUTPUT_BIAS``, so that the depth
  sits above the final ReLU, as a trained model's disparity does (with
  the draw alone about half of it is clamped to 0).
"""
from __future__ import annotations

import math

import torch
from torch import nn

OUTPUT_BIAS = 10.0
LAST_BIAS = "head.scratch.output_conv2.2.bias"


def _fan_in(w: torch.Size, transposed: bool) -> int:
    return w[1] * math.prod(w[2:]) if len(w) > 2 or transposed else w[1]


def sinusoidal(max_len: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(1, max_len, dim, dtype=torch.float64, device=device)
    pe[0, :, 0::2] = torch.sin(pos * div)
    pe[0, :, 1::2] = torch.cos(pos * div)
    return pe


def rules(shapes: nn.Module) -> dict[str, tuple[str, float]]:
    """{key: (kind, scale)} for every tensor of the state dict: kind is
    "normal", "uniform", "const" or "sine"."""
    mods = dict(shapes.named_modules())
    out = {}
    for key, t in shapes.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        m = mods.get(prefix)
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)) or leaf == "gamma":
            out[key] = ("const", 1.0 if leaf in ("weight", "gamma") else 0.0)
        elif leaf == "pe":
            out[key] = ("sine", 1.0)
        elif leaf == "mask_token":
            out[key] = ("const", 0.0)
        elif leaf in ("pos_embed", "cls_token") or prefix.endswith("proj_out"):
            out[key] = ("normal", 0.02)
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = _fan_in(m.weight.shape, isinstance(m, nn.ConvTranspose2d))
            if key.startswith("pretrained."):
                if leaf == "bias":
                    out[key] = ("const", 0.0)
                else:
                    out[key] = ("normal", 0.02 if isinstance(m, nn.Linear)
                                else math.sqrt(1.0 / fan_in))
            else:
                bound = math.sqrt(1.0 / fan_in)
                out[key] = ("uniform", bound * math.sqrt(3) if leaf == "weight" else bound)
        else:
            raise ValueError(f"no rule for {key}")
    return out


@torch.no_grad()
def state_dict(shapes: nn.Module, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The seeded state dict in ``dtype`` on ``device``; ``shapes`` is the
    reference model on the meta device."""
    rule = rules(shapes)
    sd_shapes = {k: t.shape for k, t in shapes.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = {kind: sum(math.prod(sd_shapes[k]) for k, (kd, _) in rule.items() if kd == kind)
              for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(counts["normal"], generator=gen, device=device, dtype=dtype),
             "uniform": torch.rand(counts["uniform"], generator=gen, device=device,
                                   dtype=dtype).mul_(2).sub_(1)}
    at = {"normal": 0, "uniform": 0}
    sd = {}
    for key, (kind, scale) in rule.items():
        shape = sd_shapes[key]
        if kind == "const":
            sd[key] = torch.full(shape, scale, device=device, dtype=dtype)
        elif kind == "sine":
            sd[key] = sinusoidal(shape[1], shape[2], device).to(dtype)
        else:
            n = math.prod(shape)
            sd[key] = pools[kind][at[kind]:at[kind] + n].view(shape).mul_(scale)
            at[kind] += n
    sd[LAST_BIAS].add_(OUTPUT_BIAS)
    return sd
