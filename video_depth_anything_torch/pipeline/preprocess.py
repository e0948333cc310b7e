"""Frame preprocessing on the device: uint8 -> /255 -> cv2-exact bicubic
resize to a lower-bound multiple-of-14 size (separable matmuls) -> ImageNet
normalisation. The port of the JAX package's
``pipeline/preprocess.py``."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resize import apply_separable, device_matrix, resize_bicubic_half_pixel, tracing
from ..utils import profiling


def effective_input_size(frame_h: int, frame_w: int, input_size: int = 518) -> int:
    """Aspect-ratio guard: shrink the input size for ratios above 1.78."""
    ratio = max(frame_h, frame_w) / min(frame_h, frame_w)
    if ratio > 1.78:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / 14) * 14
    return input_size


def _constrain(x: float, multiple: int, min_val: int) -> int:
    y = int(np.round(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def network_input_hw(frame_h: int, frame_w: int, input_size: int) -> tuple[int, int]:
    """Lower-bound resize (output at least input_size), multiple of 14."""
    scale = max(input_size / frame_h, input_size / frame_w)
    return (_constrain(scale * frame_h, 14, input_size),
            _constrain(scale * frame_w, 14, input_size))


def preprocess_frames(frames: torch.Tensor, out_hw: tuple[int, int],
                      dtype: torch.dtype = torch.float32, consts=None) -> torch.Tensor:
    """frames [..., H, W, 3] uint8 (or float in [0, 1]) -> normalised
    [..., h, w, 3] in ``dtype``; the resize runs in fp32 for cv2 parity.
    ``consts``: ``preprocess_consts``'s tensors for these frames, built
    ahead (``utils/serving_export.py::WindowProgram`` keeps them as
    buffers); without them they come from the per-device caches. The span
    ``vda.pipeline.preprocess``."""
    with profiling.span("vda.pipeline.preprocess"):
        x = frames.float()
        if frames.dtype == torch.uint8:
            x = x / 255.0
        if consts is None:
            x = resize_bicubic_half_pixel(x, out_hw)
            mean, std = _imagenet(x.device)
        else:
            mh, mw, mean, std = consts
            x = apply_separable(x, mh, mw)
        return ((x - mean) / std).to(dtype)


def preprocess_consts(src_hw: tuple[int, int], out_hw: tuple[int, int],
                      device: torch.device) -> tuple[torch.Tensor, ...]:
    """(cubic [h, H], cubic [w, W], ImageNet mean, std), fp32 on ``device``:
    what ``preprocess_frames`` reads for frames of ``src_hw``."""
    return (device_matrix("cubic", src_hw[0], out_hw[0], None, device, torch.float32),
            device_matrix("cubic", src_hw[1], out_hw[1], None, device, torch.float32),
            *_imagenet(device))


def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The normalisation constants on ``device``, copied there once (a copy
    per call would wait for the device's queue); under a trace built and
    not cached (``ops/resize.py::device_matrix``)."""
    if tracing():
        return _imagenet_tensors(device)
    return _cached_imagenet(device)


def _imagenet_tensors(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


_cached_imagenet = functools.lru_cache(maxsize=8)(_imagenet_tensors)
