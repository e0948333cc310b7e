"""The fused ResidualConvUnit of the RefineNet blocks: kernel K6 and its
plain version.

Replaces the JAX package's ``ops/pallas_conv.py::fused_rcu``: on NHWC x
``[N, H, W, C]``, in this order and with these roundings,

    a = relu(conv3x3(relu(x), w1) + b1)   fp32 accumulation, zero outside
                                          the image, rounded to x's dtype
    y = conv3x3(a, w2) + b2 + x           fp32 accumulation and adds,
                                          rounded once

with the weights in x's dtype and the biases in fp32. Both convolutions
are stride 1, zero padding 1: conv2 sees the intermediate zero-padded. The
CUDA source, with the note on its bound and design, is
``csrc/fused_rcu.cu``.

The kernel takes its weights as ``[3, 3, C_out, C_in]`` (tap, out, in),
re-laid once from the checkpoint's OIHW by ``kernel_weight`` (the model
caches them per module, ``models/dpt.py``). Callers gate with
``rcu_supported``, the JAX package's own gate (a TPU lane constraint:
C % 128 == 0). A tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .grad import refuse_grad

LANES = 128     # the JAX gate's channel multiple
MAX_C = 384     # the widest C whose bf16 tile fits a block's shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rcu_supported(x: torch.Tensor, use_bn: bool = False) -> bool:
    """The shapes and modes the fused kernel covers (the JAX package's
    ``rcu_supported``; callers take the two-conv path otherwise)."""
    return (not use_bn and x.dim() == 4 and x.shape[-1] % LANES == 0
            and x.shape[1] >= 3 and x.shape[2] >= 8
            and x.dtype in (torch.bfloat16, torch.float32))


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An OIHW 3x3 weight -> contiguous [3, 3, C_out, C_in] in ``dtype``."""
    return w.to(dtype).permute(2, 3, 0, 1).contiguous()


def fused_rcu_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 convolutions on the
    rounded operands, the kernel's rounding points."""
    def conv(z, w, b):
        y = F.conv2d(z.float().permute(0, 3, 1, 2), w.permute(2, 3, 0, 1).float(),
                     b.float(), padding=1)
        return y.permute(0, 2, 3, 1)

    a = torch.relu(conv(torch.relu(x), w1, b1)).to(x.dtype)
    return (conv(a, w2, b2) + x.float()).to(x.dtype)


def _bind():
    fn = build.library("fused_rcu").vda_fused_rcu
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def _check(x, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N, H, W, C]: {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    if c % 64 or c > MAX_C:
        raise ValueError(f"the kernel takes C a multiple of 64 up to {MAX_C}: C={c}")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.shape != (3, 3, c, c) or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [3, 3, {c}, {c}] {x.dtype} "
                             f"(kernel_weight), got {tuple(w.shape)} {w.dtype}")
    for name, b in (("b1", b1), ("b2", b2)):
        if b.shape != (c,) or b.dtype != torch.float32 or not b.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [{c}], got "
                             f"{tuple(b.shape)} {b.dtype}")
    if not all(t.device == x.device for t in (w1, b1, w2, b2)):
        raise ValueError("x, weights and biases must be on one device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous with a 16-byte aligned start")


def fused_rcu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x + conv2(relu(conv1(relu(x)))) on NHWC x -> a new [N, H, W, C]."""
    refuse_grad("fused_rcu (K6)", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_rcu_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_rcu runs on cuda or cpu, not {x.device}")
    _check(x, w1, b1, w2, b2)
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"fused_rcu kernel launch failed: cudaError {err}")
    fused_rcu.launches += 1
    return out


fused_rcu.launches = 0
