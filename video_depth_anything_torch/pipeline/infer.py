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

``quant="int8"`` runs both modes with the int8 model of ``ops/quant.py``,
calibrated on the first window's frames; with ``calib_path`` the
activation absmaxes persist in an ``.npz`` side file stamped with the
calibration geometry (the JAX package's format, so either package reads
the other's file) and are reused while the geometry matches.
"""
from __future__ import annotations

import copy
import os
import warnings
import zipfile

import numpy as np
import torch

from ..config import INFER_LEN, KEYFRAMES, OVERLAP, ModelConfig
from ..ops import quant as quant_ops
from ..ops.resize import resize_bilinear_align_corners
from ..utils.tree import flatten_tree, unflatten_tree
from . import preprocess, stitch, windows

# Reserved key prefix stamping the calibration geometry into the int8 side
# file (flatten_tree keys are model paths and never start with "__").
_CALIB_META = "__calib_meta__"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")   # "bfloat16", "float32"


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def _save_calib(path, stats, net_hw, dtype):
    """Persist calibration stats (a tree of NumPy arrays) atomically: a
    temp file, then os.replace."""
    # .npz suffix required: np.savez appends it to names without one.
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(
            tmp,
            **{_CALIB_META + "/net_hw": np.asarray(net_hw, np.int64),
               _CALIB_META + "/dtype": np.asarray(_dtype_name(dtype))},
            **flatten_tree(stats))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_calib(path, net_hw, dtype):
    """The stats tree if the side file matches (net_hw, dtype), else None.

    A legacy (meta-less) or mismatched file returns None; so does a
    truncated or corrupt one, with a warning. The caller recalibrates and
    overwrites it.
    """
    try:
        with np.load(path) as data:
            files = set(data.files)
            meta_hw = data[_CALIB_META + "/net_hw"] if _CALIB_META + "/net_hw" in files else None
            meta_dt = data[_CALIB_META + "/dtype"] if _CALIB_META + "/dtype" in files else None
            if (meta_hw is None or tuple(meta_hw) != tuple(net_hw)
                    or meta_dt is None or str(meta_dt) != _dtype_name(dtype)):
                return None
            flat = {k: np.asarray(data[k]) for k in data.files
                    if not k.startswith(_CALIB_META)}
        return unflatten_tree(flat)
    except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
        warnings.warn(f"unreadable int8 calibration file {path} ({e}); recalibrating")
        return None


def scale_side_file(src, dst, factor: float) -> None:
    """Copy an int8 side file with every absmax scaled by ``factor`` (the
    flip-floor run of ``utils/precision.py::flip_floor_report``)."""
    with np.load(src) as data:
        arrays = {k: data[k] if k.startswith(_CALIB_META)
                  else (data[k] * np.float32(factor)).astype(np.float32) for k in data.files}
    np.savez(dst, **arrays)


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
    def __init__(self, cfg: ModelConfig, model: torch.nn.Module, device=None,
                 quant: str | None = None, calib_path: str | None = None):
        if quant not in (None, "int8"):
            raise ValueError(f"quant={quant!r}; the pipeline takes None or 'int8'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.quant = quant
        self.calib_path = calib_path
        self._by_dtype = {torch.float32: self.model}
        self._int8: dict = {}

    def model_in(self, dtype: torch.dtype) -> torch.nn.Module:
        """The model with every parameter and buffer cast to ``dtype``
        (built once per dtype, as the JAX pipeline casts its params)."""
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = copy.deepcopy(self.model).to(dtype)
        return self._by_dtype[dtype]

    def _calib_stats(self, model, calib_win, net_hw, dtype):
        """Activation absmaxes for int8: from calib_path when it matches the
        geometry, else one calibration forward over the window's frames
        (then written to calib_path)."""
        if self.calib_path and os.path.exists(self.calib_path):
            stats = _load_calib(self.calib_path, net_hw, dtype)
            if stats is not None:
                return stats
            warnings.warn(f"{self.calib_path} was calibrated for a different "
                          f"input_size/dtype; recalibrating for net_hw={net_hw}")
        x = preprocess.preprocess_frames(self._upload(calib_win), net_hw, dtype)
        stats = _numpy_tree(model.calibrate_stats(x[None]))
        if self.calib_path:
            _save_calib(self.calib_path, stats, net_hw, dtype)
        return stats

    def quantized_model(self, calib_win, net_hw, dtype: torch.dtype) -> torch.nn.Module:
        """The int8 model for (net_hw, dtype), calibrated on ``calib_win``
        (uint8 frames) or from the side file; built once and cached."""
        key = (tuple(net_hw), dtype)
        if key not in self._int8:
            model = self.model_in(dtype)
            stats = self._calib_stats(model, calib_win, net_hw, dtype)
            self._int8[key] = quant_ops.quantize_model(model, stats)
        return self._int8[key]

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
        idx = windows.window_indices(n)
        if self.quant == "int8":
            model = self.quantized_model(frames[idx[0]], net_hw, dtype)
        else:
            model = self.model_in(dtype)
        p = self.cfg.vit.patch_size
        ph, pw = net_hw[0] // p, net_hw[1] // p
        kf = torch.tensor(KEYFRAMES, device=self.device)

        def to_source(depth):  # [32, h, w, 1] -> ReLU'd [32, src_h, src_w] fp32
            depth = resize_bilinear_align_corners(depth.float(), (src_h, src_w))
            return torch.relu(depth)[..., 0]

        outputs = []
        carry, feats = None, None
        for i, row in enumerate(idx):
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
