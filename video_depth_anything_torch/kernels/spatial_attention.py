"""Spatial attention of the ViT blocks: kernel K1 and its plain version.

Replaces the JAX package's ``ops/pallas_attention.py::
flash_attention_packed``. The CUDA source, with the note on its bound and
design, is ``csrc/spatial_attention.cu``.

q, k, v are ``[B, S, H*dh]`` views with unit innermost stride, read in
place: the fused ``attn.qkv`` projection output ``[B, S, 3C]`` goes in as
three column views with row stride 3C and no copy. The output is a
contiguous ``[B, S, C]``. K1 takes dh = 64 (every published encoder);
as in the JAX package, any other head dim goes to K4
(``kernels/attention_head_major.py``) on split-head views, writing the
``[B, S, C]`` output in place. An odd head count at dh = 64 stays on K1,
which runs one block per head. A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. The wrapper reaches
both, and the route to K4, through the custom op ``vda::spatial_attention``
(``kernels/__init__.py``).

The JAX kernel's two options are switches here, off by default (the
model's calls keep the defaults):

- ``mxu_denom=True``: the softmax denominator sums the probabilities after
  their rounding to v's dtype for PV. That is what the JAX kernel computes
  with either of its ``mxu_denom`` settings (True sums them on the matrix
  unit, False on the vector unit), so it stands for both. ``False`` sums
  the fp32 probabilities: the port's own choice, not a JAX setting. In
  fp32 the two are the same.
- ``exp2=True``: JAX's ``exp2`` option, q pre-scaled in its dtype by
  ``scale * log2(e)`` and the scores exponentiated in base 2. JAX's head-dim
  fallback has no ``exp2``, so a head dim other than 64 with ``exp2=True``
  raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import LOG2E, merge_heads, mha, scale_in, split_heads
from . import build
from .attention_head_major import run_into
from .grad import check_device, refuse_grad

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernel moves 16-byte vectors


def spatial_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, num_heads: int, scale: float, mxu_denom: bool = False,
                            exp2: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, softmax and
    accumulation, unnormalised probabilities rounded to v's dtype; the
    switches as the kernel takes them."""
    if exp2:
        q, scale = q * scale_in(q.dtype, scale * LOG2E), 1.0
    return merge_heads(mha(split_heads(q, num_heads), split_heads(k, num_heads),
                           split_heads(v, num_heads), scale, mxu_denom=mxu_denom, exp2=exp2))


def _bind(switched: bool = False):
    """The default entry, or (``switched``) the entry of the option
    instances, which live in a library of their own
    (``csrc/attention_switches.cu``)."""
    if switched:
        fn = build.library("attention_switches").vda_spatial_attention_switch
        extra = [ctypes.c_float] * 2 + [ctypes.c_int] * 2
    else:
        fn = build.library("spatial_attention").vda_spatial_attention
        extra = [ctypes.c_float]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 6 + extra + [ctypes.c_void_p])
    return fn


def _check(q, k, v, num_heads):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [B, S, C] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    c = q.shape[2]
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} only: "
                         f"C={c}, num_heads={num_heads}")
    vec = _ALIGN // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec
                or t.data_ptr() % _ALIGN):
            raise ValueError(f"{name} needs unit innermost stride, strides "
                             f"that are multiples of {vec} and a {_ALIGN}-byte "
                             f"aligned start: strides {t.stride()}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
           scale: float, mxu_denom: bool = False, exp2: bool = False) -> torch.Tensor:
    """Check the CUDA tensors and launch K1 (counted by the caller)."""
    refuse_grad("spatial_attention (K1)", q, k, v)
    _check(q, k, v, num_heads)
    b, s, c = q.shape
    out = torch.empty((b, s, c), dtype=q.dtype, device=q.device)
    switched = mxu_denom or exp2
    if exp2:   # q * scale * log2(e) rounded to q's dtype, the scores unscaled
        scales = (scale_in(q.dtype, scale * LOG2E), 1.0, int(mxu_denom), 1)
    else:
        scales = (1.0, float(scale), 1, 0) if mxu_denom else (float(scale),)
    fn = _bind(switched)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, num_heads, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1), *scales, stream)
    if err != 0:
        raise RuntimeError(f"spatial_attention kernel launch failed: cudaError {err}")
    return out


def _head_major_route(q, k, v, num_heads, scale, mxu_denom, exp2):
    """dh != 64: K4 on split-head views, written into a [B, S, C] output
    (the JAX fallback of pallas_attention.py:221-228)."""
    if exp2:
        raise ValueError(f"exp2 takes head dim {HEAD_DIM} only (the JAX fallback has no exp2): "
                         f"C={q.shape[-1]}, num_heads={num_heads}")
    if q.dim() != 3 or q.shape[2] % num_heads:
        raise ValueError(f"q must be [B, S, C] with C divisible by num_heads="
                         f"{num_heads}: {tuple(q.shape)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    run_into(*(split_heads(t, num_heads) for t in (q, k, v)), split_heads(out, num_heads),
             scale, mxu_denom)
    return out


@torch.library.custom_op("vda::spatial_attention", mutates_args=(), device_types="cpu")
def spatial_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         scale: float, mxu_denom: bool, exp2: bool) -> torch.Tensor:
    if q.shape[-1] != num_heads * HEAD_DIM:
        return _head_major_route(q, k, v, num_heads, scale, mxu_denom, exp2)
    return spatial_attention_plain(q, k, v, num_heads=num_heads, scale=scale,
                                   mxu_denom=mxu_denom, exp2=exp2)


@spatial_attention_op.register_kernel("cuda")
def _(q, k, v, num_heads, scale, mxu_denom, exp2):
    if q.shape[-1] != num_heads * HEAD_DIM:
        return _head_major_route(q, k, v, num_heads, scale, mxu_denom, exp2)
    out = launch(q, k, v, num_heads=num_heads, scale=scale, mxu_denom=mxu_denom, exp2=exp2)
    spatial_attention.launches += 1
    return out


@spatial_attention_op.register_fake
def _(q, k, v, num_heads, scale, mxu_denom, exp2):
    return q.new_empty(q.shape)


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_heads: int, scale: float, mxu_denom: bool = False,
                      exp2: bool = False) -> torch.Tensor:
    """Multi-head attention on [B, S, H*dh] -> contiguous [B, S, H*dh]."""
    refuse_grad("spatial_attention (K1)", q, k, v)
    check_device("spatial_attention", q)
    return spatial_attention_op(q, k, v, num_heads, float(scale), mxu_denom, exp2)


spatial_attention.launches = 0
