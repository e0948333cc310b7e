"""Frame preprocessing on the device: uint8 -> /255 -> cv2-exact bicubic
resize to a lower-bound multiple-of-14 size (separable matmuls) -> ImageNet
normalisation. The port of the JAX package's
``pipeline/preprocess.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resize import resize_bicubic_half_pixel


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
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frames [..., H, W, 3] uint8 (or float in [0, 1]) -> normalised
    [..., h, w, 3] in ``dtype``; the resize runs in fp32 for cv2 parity."""
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    x = resize_bicubic_half_pixel(x, out_hw)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)
