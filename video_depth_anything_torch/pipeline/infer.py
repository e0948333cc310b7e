"""VideoDepthPipeline: sliding-window video depth on one device.

The port of the JAX package's ``pipeline/infer.py``'s
``infer_video_depth`` in its two single-device modes:

- sequential keyframe cache (the default): the encoder is strictly
  per-frame and each window's first OVERLAP inputs are the previous
  window's KEYFRAMES inputs, so their tap features are reused and only the
  22 new frames are encoded; the temporal head sees all 32.
- plain (``cache_keyframe_features=False``): the full 32-frame forward per
  window.

Both return ``(depths [N, H, W] float32, fps)``. Preprocessing, the
forward, the resize to source resolution and the fp32 stitching all run on
the pipeline's device; each window's finalised frames are then copied to
the host.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import INFER_LEN, KEYFRAMES, OVERLAP, ModelConfig
from ..ops.resize import resize_bilinear_align_corners
from . import preprocess, stitch, windows


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class VideoDepthPipeline:
    def __init__(self, cfg: ModelConfig, model: torch.nn.Module, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._by_dtype = {torch.float32: self.model}

    def model_in(self, dtype: torch.dtype) -> torch.nn.Module:
        """The model with every parameter and buffer cast to ``dtype``
        (built once per dtype, as the JAX pipeline casts its params)."""
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = copy.deepcopy(self.model).to(dtype)
        return self._by_dtype[dtype]

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    @torch.no_grad()
    def infer_video_depth(self, frames, target_fps: float = -1,
                          input_size: int = 518, fp32: bool = False,
                          cache_keyframe_features: bool = True):
        """frames: [N, H, W, 3] uint8 (or float in [0, 1]).

        Returns (depths [N, H, W] float32, target_fps).
        """
        frames = np.asarray(frames)
        n, src_h, src_w = frames.shape[:3]
        eff = preprocess.effective_input_size(src_h, src_w, input_size)
        net_hw = preprocess.network_input_hw(src_h, src_w, eff)
        dtype = torch.float32 if fp32 else torch.bfloat16
        model = self.model_in(dtype)
        p = self.cfg.vit.patch_size
        ph, pw = net_hw[0] // p, net_hw[1] // p
        kf = torch.tensor(KEYFRAMES, device=self.device)

        def to_source(depth):  # [32, h, w, 1] -> ReLU'd [32, src_h, src_w] fp32
            depth = resize_bilinear_align_corners(depth.float(), (src_h, src_w))
            return torch.relu(depth)[..., 0]

        outputs = []
        carry, feats = None, None
        for i, row in enumerate(windows.window_indices(n)):
            if cache_keyframe_features:
                rows = row if i == 0 else row[OVERLAP:]
                x = preprocess.preprocess_frames(self._upload(frames[rows]),
                                                 net_hw, dtype)
                new = model.encode(x)
                if feats is not None:
                    new = [(torch.cat([pt[kf], nt]), torch.cat([pc[kf], nc]))
                           for (pt, pc), (nt, nc) in zip(feats, new)]
                feats = new
                depth = to_source(model.head(feats, ph, pw, 1, INFER_LEN))
            else:
                x = preprocess.preprocess_frames(self._upload(frames[row]),
                                                 net_hw, dtype)
                depth = to_source(model(x[None])[0][..., None])
            if carry is None:
                carry, emit = stitch.stitch_first(depth)
            else:
                carry, emit = stitch.stitch_step(carry, depth, metric=self.cfg.metric)
            outputs.append(emit.cpu().numpy())
        outputs.append(carry[2].cpu().numpy())
        return np.concatenate(outputs, axis=0)[:n].astype(np.float32), target_fps
