"""Head-major attention for any head dim: kernel K4 and its plain version.

Replaces the JAX package's ``ops/pallas_attention.py::flash_attention``,
where ``flash_attention_packed`` sends the head dims it cannot pair on the
TPU's matrix unit. The port routes every head dim K1 does not take (dh !=
64) here. The CUDA source, with the note on its bound and design, is
``csrc/attention_head_major.cu``.

q, k, v are ``[B, H, S, D]`` with unit innermost stride, read in place
through their strides: contiguous head-major tensors or split-head views
of a ``[B, S, H*D]`` projection (``ops.attention.split_heads``). D is a
multiple of 8, at most 128. As in the JAX wrapper, q is pre-scaled in its
own dtype (the scale rounded to that dtype, then the product), and the
scores take no further scale. Unlike it, the kernel streams its keys, so
S has no limit (the JAX wrapper sends S > 8448 to XLA). A tensor on the
CPU takes the plain version; a CUDA tensor launches the kernel or raises.

``mxu_denom=True`` sums the softmax denominator from the probabilities
rounded to v's dtype, as the JAX kernel does with either of its
``mxu_denom`` settings; ``False`` (the default, the model's) sums the fp32
ones, the port's own choice (see ``kernels/spatial_attention.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.attention import mha, scale_in
from . import build
from .grad import refuse_grad

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernel moves 16-byte vectors


def attention_head_major_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, scale: float, mxu_denom: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q pre-scaled in its dtype,
    then fp32 scores, softmax and accumulation, unnormalised probabilities
    rounded to v's dtype."""
    return mha(q * scale_in(q.dtype, scale), k, v, 1.0, mxu_denom=mxu_denom)


def _bind(mxu_denom: bool = False):
    """The default entry, or that of the mxu_denom instances, which live in
    a library of their own (``csrc/attention_switches.cu``)."""
    fn = (build.library("attention_switches").vda_attention_head_major_ones if mxu_denom
          else build.library("attention_head_major").vda_attention_head_major)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v, out):
    if not (q.shape == k.shape == v.shape == out.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v and out must share one [B, H, S, D] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(out.shape)}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v and out must all be float32 or bfloat16, got "
                        f"{q.dtype} {k.dtype} {v.dtype} {out.dtype}")
    if not (q.device == k.device == v.device == out.device):
        raise ValueError("q, k, v and out must be on one device")
    d = q.shape[3]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are multiples of 8 up "
                         f"to {MAX_HEAD_DIM}: D={d}")
    vec = _ALIGN // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if (t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3))
                or t.data_ptr() % _ALIGN):
            raise ValueError(f"{name} needs unit innermost stride, strides that are "
                             f"multiples of {vec} and a {_ALIGN}-byte aligned start: "
                             f"strides {t.stride()}")


def attention_head_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, out: torch.Tensor | None = None,
                         mxu_denom: bool = False) -> torch.Tensor:
    """Multi-head attention on [B, H, S, D] -> [B, H, S, D].

    With ``out`` (a [B, H, S, D] view with unit innermost stride, such as
    the split heads of a [B, S, H*D] tensor) the result is written there and
    ``out`` is returned; otherwise into a new contiguous tensor.
    """
    refuse_grad("attention_head_major (K4)", q, k, v, out)
    if q.device.type == "cpu":
        o = attention_head_major_plain(q, k, v, scale=scale, mxu_denom=mxu_denom)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_head_major runs on cuda or cpu, not {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k, v, out)
    b, h, s, d = q.shape
    if q.numel() == 0:
        return out
    fn = _bind(mxu_denom)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, s, d, *strides, scale_in(q.dtype, scale), stream)
    if err != 0:
        raise RuntimeError(f"attention_head_major kernel launch failed: cudaError {err}")
    attention_head_major.launches += 1
    return out


attention_head_major.launches = 0
