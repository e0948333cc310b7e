"""The output head's full-resolution tail: kernel K7 and its plain version.

On the mixed island (bf16 input, not training; ``models/dpt.py::Scratch
.output_head``), from output_conv1's NHWC map x ``[N, h, w, C]`` bf16 to
the depth ``[N, H, W, 1]`` fp32:

    u = bilinear align-corners upsample of x to (H, W), bf16
    a = bf16(relu(conv3x3(u, w1) + b1))       C -> 32, fp32 accumulation
    y = relu(a . w2 + b2)                     fp32

The plain version is that chain as ``Scratch``'s stages run it with
PyTorch's operators: the two einsums of ``ops/resize.py``, a bf16
convolution, whose output rounds to bf16 before the fp32 bias (no PyTorch
convolution takes bf16 in and gives fp32 out), then the fp32 tail. The kernel (``csrc/head_output_tail.cu``) adds b1 to
its fp32 accumulator before that rounding, as the JAX package's island
does (``models/dpt.py::output_head``): the one difference between the two,
which the card tests hold to a stated tolerance. Its upsample takes, per
output row and column, the two nonzeros of ``device_matrix("linear",
...)`` in bf16 (``interp_table``), the rows first, each pass rounded to
bf16, as the einsums do.

``tail_supported`` is the gate (C a multiple of 16 up to ``MAX_C``, an
upsample of at least 1.5x, as the model's 1.75x is). The custom op
``vda::head_output_tail`` runs the plain version on the CPU and the kernel
on a CUDA tensor (or raises); its fake implementation gives the output's
shape, so ``torch.export`` records the op (``utils/serving_export.py``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import nn as vnn
from ..ops.resize import device_matrix, resize_bilinear_align_corners
from . import build
from .grad import check_device, refuse_grad

MAX_C = 192     # the widest C whose weights and tiles fit a block's shared memory
NOUT = 32       # output_conv2's 3x3 width


def tail_supported(dtype: torch.dtype, channels: int, in_hw, out_hw) -> bool:
    """The inputs K7 takes: a bf16 map of ``channels`` (a multiple of 16 up
    to ``MAX_C``) upsampled at least 1.5x from ``in_hw`` to ``out_hw``."""
    (h, w), (oh, ow) = in_hw, out_hw
    return (dtype == torch.bfloat16 and channels % 16 == 0 and 0 < channels <= MAX_C
            and h >= 2 and w >= 2 and 2 * (oh - 1) >= 3 * (h - 1)
            and 2 * (ow - 1) >= 3 * (w - 1))


@functools.lru_cache(maxsize=64)
def interp_table(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, 4] float32: per output row of the bf16 interpolation
    matrix ``device_matrix("linear", in_size, out_size)``, its first tap
    lo (at most in_size - 2; the int32's bits, read as such by the kernel),
    the weights at lo and lo + 1, and 0. Those two columns hold every
    nonzero of the row."""
    m = device_matrix("linear", in_size, out_size, None, torch.device("cpu"),
                      torch.bfloat16).float().numpy()
    lo = np.minimum(np.argmax(m != 0, axis=1), in_size - 2)
    rows = np.arange(out_size)
    tab = np.zeros((out_size, 4), np.float32)
    tab[:, 0] = lo.astype(np.int32).view(np.float32)
    tab[:, 1], tab[:, 2] = m[rows, lo], m[rows, lo + 1]
    tab.flags.writeable = False
    return tab


@functools.lru_cache(maxsize=64)
def _device_table(in_size: int, out_size: int, device: torch.device):
    """``interp_table`` on ``device`` and its lo column on the host (int32),
    from which the launch sizes the tiles' source box."""
    tab = interp_table(in_size, out_size)
    lo = np.ascontiguousarray(tab[:, 0].view(np.int32))
    return torch.from_numpy(np.array(tab)).to(device), lo


def kernel_weight(w1: torch.Tensor) -> torch.Tensor:
    """output_conv2's OIHW [32, C, 3, 3] 3x3 weight -> contiguous bf16
    [9, C / 8, 32, 8] (tap, channel group, out, channel): wgmma's K-major B
    tiles, 16-byte core-matrix rows."""
    o, c = w1.shape[:2]
    return (w1.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, o, c // 8, 8)
            .permute(0, 2, 1, 3).contiguous())


def head_output_tail_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, out_hw) -> torch.Tensor:
    """The tail with PyTorch's operators: the resize, the bf16 3x3 conv
    (rounded before its fp32 bias), relu, bf16, the fp32 1x1 and its relu;
    ``Scratch.head_resize`` / ``head_conv2a`` / ``head_conv2b`` on the mixed
    island, op for op. Returns [N, H, W, 1] fp32."""
    a = vnn.conv2d(resize_bilinear_align_corners(x, out_hw), w1, None, padding=1)
    a = torch.relu(a.float() + b1.float()).to(torch.bfloat16)
    out = torch.matmul(a.float(), w2.float().reshape(-1, 1))
    return torch.relu(out + b2.float())


def _bind():
    fn = build.library("head_output_tail").vda_head_output_tail
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, w1, b1, w2, b2, out_h, out_w):
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a bf16 NHWC [N, h, w, C], got {tuple(x.shape)} {x.dtype}")
    n, h, w, c = x.shape
    if not tail_supported(x.dtype, c, (h, w), (out_h, out_w)):
        raise ValueError(f"K7 takes C a multiple of 16 up to {MAX_C} and an upsample of at "
                         f"least 1.5x: C={c}, {h}x{w} -> {out_h}x{out_w}")
    if tuple(w1.shape) != (NOUT, c, 3, 3) or b1.numel() != NOUT:
        raise ValueError(f"w1, b1 must be [{NOUT}, {c}, 3, 3], [{NOUT}]: "
                         f"{tuple(w1.shape)}, {tuple(b1.shape)}")
    if w2.numel() != NOUT or b2.numel() != 1:
        raise ValueError(f"w2, b2 must hold {NOUT} and 1 values: {tuple(w2.shape)}, "
                         f"{tuple(b2.shape)}")
    if not all(t.device == x.device for t in (w1, b1, w2, b2)):
        raise ValueError("x, weights and biases must be on one device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous with a 16-byte aligned start")


@torch.library.custom_op("vda::head_output_tail", mutates_args=(), device_types="cpu")
def head_output_tail_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return head_output_tail_plain(x, w1, b1, w2, b2, (out_h, out_w)).contiguous()


@head_output_tail_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, out_h, out_w):
    _check(x, w1, b1, w2, b2, out_h, out_w)
    n, h, w, c = x.shape
    out = torch.empty((n, out_h, out_w, 1), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    wk = kernel_weight(w1)
    b1f, w2f, b2f = (t.float().reshape(-1).contiguous() for t in (b1, w2, b2))
    rows, row_lo = _device_table(h, out_h, x.device)
    cols, col_lo = _device_table(w, out_w, x.device)
    fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(), b1f.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
                 rows.data_ptr(), cols.data_ptr(), out.data_ptr(), row_lo.ctypes.data,
                 col_lo.ctypes.data, n, h, w, c, out_h, out_w, _sm_count(x.device.index), stream)
    if err != 0:
        raise RuntimeError(f"head_output_tail kernel launch failed: cudaError {err}")
    head_output_tail.launches += 1
    return out


@head_output_tail_op.register_fake
def _(x, w1, b1, w2, b2, out_h, out_w):
    return x.new_empty((x.shape[0], out_h, out_w, 1), dtype=torch.float32)


def head_output_tail(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, out_hw) -> torch.Tensor:
    """output_conv2 (3x3 to 32, relu, 1x1 to 1, relu) on x upsampled to
    ``out_hw``: NHWC bf16 x -> [N, H, W, 1] fp32."""
    refuse_grad("head_output_tail (K7)", x, w1, b1, w2, b2)
    check_device("head_output_tail", x)
    return head_output_tail_op(x, w1, b1, w2, b2, int(out_hw[0]), int(out_hw[1]))


head_output_tail.launches = 0
