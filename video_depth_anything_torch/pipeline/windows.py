"""Sliding-window frame indexing in closed form.

Each 32-frame window re-injects the previous window's KEYFRAMES inputs in
its first OVERLAP slots. The dependency is on inputs, not outputs, so all
windows' source-frame indices are known up front; indices past the video
clamp to its last frame (the reference's tail padding). The port's copy of
the JAX package's ``pipeline/windows.py``.
"""
from __future__ import annotations

import numpy as np

from ..config import FRAME_STEP, INFER_LEN, KEYFRAMES


def num_windows(video_len: int) -> int:
    return -(-video_len // FRAME_STEP)


def window_indices(video_len: int) -> np.ndarray:
    """[K, 32] int32 source-frame indices for every window."""
    k = num_windows(video_len)
    idx = np.zeros((k, INFER_LEN), dtype=np.int32)
    idx[0] = np.arange(INFER_LEN)
    kf = np.asarray(KEYFRAMES)
    for i in range(1, k):
        idx[i, : len(kf)] = idx[i - 1, kf]
        idx[i, len(kf):] = i * FRAME_STEP + np.arange(len(kf), INFER_LEN)
    return np.minimum(idx, video_len - 1)
