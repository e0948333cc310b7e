"""SwiGLU's gate, ``silu(x1) * x2``: kernel K8 and its plain version.

vitg's fused SwiGLU FFN (``models/dinov2.py::SwiGLUFFNFused``) maps the
block's normed tokens through ``w12`` to y ``[..., 2H]``, gates the first
half by the second and maps the result through ``w3``. The plain version
is that gate as PyTorch's operators run it: ``chunk`` into two strided
views, ``F.silu`` (fp32 inside, rounded to the tensor's dtype), the
product (rounded again). The kernel (``csrc/swiglu.cu``) takes a
contiguous bf16 y and does both in one pass with the same two roundings,
so on the card it gives the plain version's bits.

The custom op ``vda::swiglu`` runs the plain version on the CPU and the
kernel on a CUDA tensor (or raises: bf16 only, H a multiple of 8, y
contiguous and 16-byte aligned); its fake implementation gives the
output's shape, so ``torch.export`` records the op.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from . import build
from .grad import check_device, refuse_grad


def swiglu_plain(y: torch.Tensor) -> torch.Tensor:
    """silu(y[..., :H]) * y[..., H:] with PyTorch's operators."""
    x1, x2 = y.chunk(2, dim=-1)
    return F.silu(x1) * x2


def _bind():
    fn = build.library("swiglu").vda_swiglu
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _check(y: torch.Tensor) -> None:
    if y.dtype != torch.bfloat16 or y.dim() < 1 or y.shape[-1] % 16:
        raise ValueError(f"K8 takes a bf16 [..., 2H] with H a multiple of 8: "
                         f"{tuple(y.shape)} {y.dtype}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("K8 takes a contiguous y with a 16-byte aligned start")


@torch.library.custom_op("vda::swiglu", mutates_args=(), device_types="cpu")
def swiglu_op(y: torch.Tensor) -> torch.Tensor:
    return swiglu_plain(y)


@swiglu_op.register_kernel("cuda")
def _(y):
    _check(y)
    hidden = y.shape[-1] // 2
    out = torch.empty((*y.shape[:-1], hidden), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _bind()(y.data_ptr(), out.data_ptr(), y.numel() // y.shape[-1], hidden, stream)
    if err != 0:
        raise RuntimeError(f"swiglu kernel launch failed: cudaError {err}")
    swiglu.launches += 1
    return out


@swiglu_op.register_fake
def _(y):
    return y.new_empty((*y.shape[:-1], y.shape[-1] // 2))


def swiglu(y: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 of y = [x1, x2] on its last axis: [..., 2H] -> [..., H]."""
    refuse_grad("swiglu (K8)", y)
    check_device("swiglu", y)
    return swiglu_op(y)


swiglu.launches = 0
