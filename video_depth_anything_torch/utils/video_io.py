"""Host-side video decode and encode with OpenCV (the port's copy of the
cv2 backend of the JAX package's ``utils/video_io.py``).

fps-stride resampling, max_res downscale to even sizes, max_len
truncation, and an inferno or grayscale depth visualisation. cv2 (and
matplotlib for the inferno palette) are imported inside the functions:
machines that only run the model need neither.
"""
from __future__ import annotations

import numpy as np


def _ensure_even(v: int) -> int:
    return v if v % 2 == 0 else v + 1


def read_video_frames(video_path: str, process_length: int = -1,
                      target_fps: float = -1, max_res: int = -1):
    """-> (frames [N, H, W, 3] uint8 RGB, fps)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    try:
        original_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        scale_hw = None
        if max_res > 0 and max(h, w) > max_res:
            scale = max_res / max(h, w)
            scale_hw = (_ensure_even(round(h * scale)), _ensure_even(round(w * scale)))
        fps = original_fps if target_fps <= 0 else target_fps
        stride = max(round(original_fps / fps), 1)
        frames = []
        count = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if count % stride == 0:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if scale_hw is not None:
                    frame = cv2.resize(frame, (scale_hw[1], scale_hw[0]),
                                       interpolation=cv2.INTER_AREA)
                frames.append(frame)
                if 0 < process_length <= len(frames):
                    break
            count += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames, axis=0), fps


def depth_visualization(depths: np.ndarray, grayscale: bool = False) -> np.ndarray:
    """Globally min-max normalised depth video -> uint8 RGB."""
    d_min, d_max = float(depths.min()), float(depths.max())
    norm = ((depths - d_min) / ((d_max - d_min) or 1.0) * 255).astype(np.uint8)
    if grayscale:
        return np.repeat(norm[..., None], 3, axis=-1)
    import matplotlib
    lut = (np.asarray(matplotlib.colormaps["inferno"].colors) * 255).astype(np.uint8)
    return lut[norm]


def save_video(frames: np.ndarray, output_path: str, fps: float = 10,
               is_depths: bool = False, grayscale: bool = False) -> None:
    """Write an mp4 (OpenCV mp4v). frames: [N, H, W, 3] uint8 RGB, or
    [N, H, W] float depth when ``is_depths``."""
    import cv2

    if is_depths:
        frames = depth_visualization(np.asarray(frames), grayscale)
    frames = np.asarray(frames)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {output_path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
