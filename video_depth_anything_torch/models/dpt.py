"""DPT spatial decoder pieces, NHWC.

The port of the JAX package's ``models/dpt.py``: residual conv
units, RefineNet fusion blocks with the 1x1 out_conv run before the 2x
upsample (a pointwise affine map commutes exactly with align-corners
bilinear, whose weights sum to 1), the 3x3 "scratch" convs, and the output
head with its fp32 island (fp32 input) or bf16 mixed island (bf16 input).
All upsampling is bilinear ``align_corners=True``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import nn as vnn
from ..ops.resize import resize_bilinear_align_corners


def _conv(features_in: int, features_out: int, k: int, bias: bool = True):
    return nn.Conv2d(features_in, features_out, k, padding=k // 2, bias=bias)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the skip (no BatchNorm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3)
        self.conv2 = _conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = vnn.conv2d(torch.relu(x), self.conv1.weight, self.conv1.bias, padding=1)
        y = vnn.conv2d(torch.relu(y), self.conv2.weight, self.conv2.bias, padding=1)
        return y + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = _conv(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                size: tuple[int, int] | None = None) -> torch.Tensor:
        """size=None means a 2x upsample (refinenet1)."""
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        out = vnn.conv2d(out, self.out_conv.weight, self.out_conv.bias)
        if size is None:
            size = (2 * out.shape[1], 2 * out.shape[2])
        return resize_bilinear_align_corners(out, size)


class Scratch(nn.Module):
    def __init__(self, out_channels, features: int):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", _conv(c, features, 3, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = _conv(features, features // 2, 3)
        self.output_conv2 = nn.Sequential(_conv(features // 2, 32, 3), nn.ReLU(),
                                          _conv(32, 1, 1))

    def rn(self, feats):
        """3x3 no-bias feature harmonisation convs."""
        return [vnn.conv2d(f, getattr(self, f"layer{i + 1}_rn").weight, padding=1)
                for i, f in enumerate(feats)]

    def output_head(self, path_1: torch.Tensor, out_hw) -> torch.Tensor:
        """output_conv1 -> bilinear upsample to out_hw -> output_conv2.

        fp32 input: the reference's fp32 island. bf16 input: the mixed
        island — the full-resolution 3x3 conv keeps bf16 storage, and its
        bias, the ReLU, the 32->1 reduction and the final ReLU run in fp32.
        PyTorch has no bf16-in / fp32-out convolution, so the 3x3 conv's
        output rounds to bf16 before the fp32 bias (the JAX island adds
        the bias to the fp32 accumulator, then rounds).
        Returns [N, H, W, 1] fp32.
        """
        c1 = self.output_conv1
        out = vnn.conv2d(path_1, c1.weight, c1.bias, padding=1)
        out = resize_bilinear_align_corners(out, out_hw)
        c2a, c2b = self.output_conv2[0], self.output_conv2[2]
        if out.dtype == torch.float32:
            out = torch.relu(vnn.conv2d(out, c2a.weight, c2a.bias, padding=1))
            return torch.relu(vnn.conv2d(out, c2b.weight, c2b.bias))
        out = vnn.conv2d(out, c2a.weight, None, padding=1)
        out = torch.relu(out.float() + c2a.bias.float()).to(torch.bfloat16)
        out = torch.matmul(out.float(), c2b.weight.float().reshape(-1, 1))
        return torch.relu(out + c2b.bias.float())
