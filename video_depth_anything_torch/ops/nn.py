"""Core NN primitives on channel-last tensors, with fp32 islands.

Weights keep PyTorch's own layouts (the checkpoint's): linear ``[out, in]``,
conv ``OIHW``, transposed conv ``IOHW``. Activations keep the JAX package's
layouts: maps are NHWC. A contiguous NHWC tensor permuted to NCHW is a
channels-last tensor, which the convolution takes without a copy and
returns channels-last, so the permutes around it move no bytes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


class _LinearF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = torch.mm(x2.float(), w.t().float())
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def linear_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ weight [N, K]^T in x's dtype with an fp32 output: the
    products of a bf16 GEMM, accumulated in fp32 and left unrounded (a
    partial sum that is added to others before it is rounded once). The
    backward is the bf16 linear's: the fp32 gradient is rounded to x's
    dtype first."""
    weight = weight.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, weight)
    return _LinearF32.apply(x, weight)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics.

    bf16 input: mean and E[x^2] - mean^2 accumulate in fp32, the
    normalisation runs in bf16 (the JAX package's rule,
    ops/nn.py::layer_norm). Any other input (fp32; float64 for gradcheck):
    the exact two-pass computation in its own dtype.
    """
    if x.dtype != torch.bfloat16:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
        return y * weight + bias
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mean.to(x.dtype)) * inv
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the channels of x[B, ..., C], two-pass statistics in
    fp32 (or x's dtype where it is wider) over (spatial, channels-in-group)
    per sample; output in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc).reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    d = xf - mean
    var = d.square().mean(dim=(1, 3), keepdim=True)
    y = (d * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * weight.to(acc) + bias.to(acc)
    return y.to(x.dtype).reshape(x.shape)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), with the JAX package's derivative at the tie
    (``jnp.maximum(x, 0)``: 1/2 at x == 0, where ``torch.relu`` gives 0)."""
    return torch.maximum(x, x.new_zeros(()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32; the tanh form in bf16 (its error is below
    bf16 rounding)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NHWC convolution with an OIHW weight (torch Conv2d semantics)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None, stride: int) -> torch.Tensor:
    """NHWC ConvTranspose2d(k == stride, no padding) with an IOHW weight.

    With kernel == stride every output pixel takes exactly one (input
    pixel, tap) term, so the transpose is one matmul and a block reshape.
    """
    cin, cout, kh, kw = weight.shape
    if (kh, kw) != (stride, stride):
        raise ValueError("only kernel_size == stride is supported")
    b, h, w, _ = x.shape
    wmat = weight.to(x.dtype).permute(0, 2, 3, 1).reshape(cin, kh * kw * cout)
    y = torch.matmul(x, wmat).reshape(b, h, w, kh, kw, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * kh, w * kw, cout)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y
