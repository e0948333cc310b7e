"""Exact-coordinate resizing as separable matmuls.

Three conventions of the reference stack, reproduced for checkpoint parity:

1. bilinear ``align_corners=True`` (depth upsample, DPT fusion, head):
   src = dst * (in - 1) / (out - 1).
2. bicubic with a given ``scale_factor`` (DINOv2 pos-embed, +0.1 quirk):
   src = (dst + 0.5) / s - 0.5, cubic A = -0.75, border-clamped taps.
3. cv2 ``INTER_CUBIC`` (frame preprocessing): src = (dst + 0.5) * in / out
   - 0.5, cubic A = -0.75, replicate border.

The 1-D interpolation matrices are built once in NumPy (the port's own copy
of the JAX package's builders) and applied with ``torch.einsum``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (same A = -0.75 as torch and cv2)."""
    t = np.abs(t)
    t2 = t * t
    t3 = t2 * t
    return np.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def cubic_resize_matrix(in_size: int, out_size: int,
                        scale: float | None = None) -> np.ndarray:
    """[out, in] cubic interpolation matrix with half-pixel coordinates.

    With ``scale``, src = (dst + 0.5) / scale - 0.5 (torch scale_factor
    semantics); otherwise scale = out / in (cv2 and torch size semantics).
    Taps are index-clamped (replicate border).
    """
    s = float(scale) if scale is not None else out_size / in_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / s - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        idx = np.clip(base + k, 0, in_size - 1)
        np.add.at(mat, (rows, idx), _cubic_weight(frac - k))
    mat = mat.astype(np.float32)
    mat.flags.writeable = False   # shared by every caller of the cache
    return mat


@functools.lru_cache(maxsize=256)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear align-corners interpolation matrix."""
    dst = np.arange(out_size, dtype=np.float64)
    src = dst * ((in_size - 1) / (out_size - 1)) if out_size > 1 else dst * 0.0
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - w)
    np.add.at(mat, (rows, hi), w)
    mat = mat.astype(np.float32)
    mat.flags.writeable = False
    return mat


def tracing() -> bool:
    """True while a trace runs this code: ``torch.export`` or
    ``torch.compile`` (whose tensors are fake, so nothing built then may be
    cached for a live call)."""
    from torch._guards import detect_fake_mode

    return torch.compiler.is_compiling() or detect_fake_mode() is not None


def device_matrix(kind: str, in_size: int, out_size: int, scale: float | None,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The ``kind`` ("cubic" or "linear") matrix on ``device`` in ``dtype``,
    copied there once. A host-to-device copy from pageable memory waits for
    the device's queue to drain, so a copy per call would stall the host
    behind the card on every resize. Under a trace the matrix is built and
    not cached: the trace's tensor is a fake one, and a later live call
    would get it back."""
    if tracing():
        return _build_matrix(kind, in_size, out_size, scale, device, dtype)
    return _cached_matrix(kind, in_size, out_size, scale, device, dtype)


def _build_matrix(kind, in_size, out_size, scale, device, dtype) -> torch.Tensor:
    mat = (cubic_resize_matrix(in_size, out_size, scale) if kind == "cubic"
           else linear_resize_matrix(in_size, out_size))
    return torch.from_numpy(np.array(mat)).to(device=device, dtype=dtype)


_cached_matrix = functools.lru_cache(maxsize=256)(_build_matrix)


def apply_separable(x: torch.Tensor, mh: torch.Tensor,
                    mw: torch.Tensor) -> torch.Tensor:
    """Apply [Ho, H] and [Wo, W] factors to x[..., H, W, C] in x's dtype."""
    x = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, x)


def resize_bicubic_half_pixel(x: torch.Tensor, out_hw: tuple[int, int],
                              scale_hw: tuple[float, float] | None = None
                              ) -> torch.Tensor:
    """Bicubic resize of x[..., H, W, C]: cv2 INTER_CUBIC when scale_hw is
    None, torch ``F.interpolate(scale_factor=..., mode='bicubic')`` when
    given."""
    h, w = x.shape[-3], x.shape[-2]
    sh, sw = (None, None) if scale_hw is None else scale_hw
    return apply_separable(x, device_matrix("cubic", h, out_hw[0], sh, x.device, x.dtype),
                           device_matrix("cubic", w, out_hw[1], sw, x.device, x.dtype))


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of x[..., H, W, C] (torch
    ``F.interpolate(mode='bilinear', align_corners=True)``)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == tuple(out_hw):
        return x
    return apply_separable(x, device_matrix("linear", h, out_hw[0], None, x.device, x.dtype),
                           device_matrix("linear", w, out_hw[1], None, x.device, x.dtype))
