"""The published sliding-window inference in plain PyTorch: the reference
for what ``infer_video_depth`` returns.

Follows ``VideoDepthAnything.infer_video_depth`` of
github.com/DepthAnything/Video-Depth-Anything: each frame is scaled to
[0, 1], resized with cv2's INTER_CUBIC to the lower-bound multiple-of-14
size (the aspect guard shrinking the input size above 1.78) and
normalised; windows of 32 frames step by 22, the first 10 inputs of each
window being the previous window's keyframe inputs (0, 12, 24..31); the
tail is padded with the last frame; each window's depth is resized to the
source (bilinear, align corners); then the windows are stitched: the
first two depths of each later window are fitted by least squares to the
two references (frame 0 and the previous window's aligned keyframe 12),
the window is mapped by that scale and shift and clamped at 0, and the 8
overlap frames are cross-faded linearly. The metric model
(``metric=True``) keeps scale 1 and shift 0 and the clamp and cross-fade.

Departures, none of which changes the function: cv2's resize is written
out as its separable cubic matrices (no cv2 on the card's machine); a
keyframe's tap features are kept instead of encoding its input again
(the encoder works frame by frame); the least-squares fit is solved in
float64; the encoder runs in blocks of frames so that it fits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INFER_LEN, OVERLAP, INTERP_LEN = 32, 10, 8
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
FRAME_STEP = INFER_LEN - OVERLAP
ALIGN_LEN = OVERLAP - INTERP_LEN
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def network_size(src_h: int, src_w: int, input_size: int = 518) -> tuple[int, int]:
    """The published transform's output size: the aspect guard, then
    ``Resize(keep_aspect_ratio, lower_bound, ensure_multiple_of=14)``."""
    ratio = max(src_h, src_w) / min(src_h, src_w)
    if ratio > 1.78:
        input_size = round(int(input_size * 1.777 / ratio) / 14) * 14
    scale = max(input_size / src_h, input_size / src_w)

    def constrain(x):
        y = int(np.round(x / 14) * 14)
        return y if y >= input_size else int(np.ceil(x / 14) * 14)

    return constrain(scale * src_h), constrain(scale * src_w)


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """cv2 INTER_CUBIC as an [n_out, n_in] matrix: half-pixel centres,
    Keys' cubic with A = -0.75, taps clamped at the border."""
    a = -0.75
    src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    m = np.zeros((n_out, n_in))
    for k in range(-1, 3):
        t = np.abs(frac - k)
        w = np.where(t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                     np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0))
        np.add.at(m, (np.arange(n_out), np.clip(base + k, 0, n_in - 1)), w)
    return m


def preprocess(frames: torch.Tensor, net_hw) -> torch.Tensor:
    """uint8 frames [N, H, W, 3] on the device -> normalised [N, 3, h, w]
    float32."""
    n, h, w, _ = frames.shape
    dev = frames.device
    mh = torch.tensor(cubic_matrix(h, net_hw[0]), dtype=torch.float32, device=dev)
    mw = torch.tensor(cubic_matrix(w, net_hw[1]), dtype=torch.float32, device=dev)
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    x = mh @ x @ mw.T
    mean = torch.tensor(MEAN, device=dev)[:, None, None]
    std = torch.tensor(STD, device=dev)[:, None, None]
    return (x - mean) / std


def scale_and_shift(pred: torch.Tensor, target: torch.Tensor):
    """The published closed-form least squares of target ~ s * pred + t,
    in float64."""
    p, t = pred.double().flatten(), target.double().flatten()
    a00, a01, a11 = (p * p).sum(), p.sum(), float(p.numel())
    b0, b1 = (p * t).sum(), t.sum()
    det = a00 * a11 - a01 * a01
    if det == 0:
        return 1.0, 0.0
    return float((a11 * b0 - a01 * b1) / det), float((-a01 * b0 + a00 * b1) / det)


@torch.no_grad()
def window_depths(model, frames: torch.Tensor, input_size: int = 518, block: int = 4):
    """Yields each window's depth [32, H, W] float32 at the source size,
    frames [N, H, W, 3] uint8 on the device."""
    n, src_h, src_w, _ = frames.shape
    net_hw = network_size(src_h, src_w, input_size)
    pad = (FRAME_STEP - n % FRAME_STEP) % FRAME_STEP + OVERLAP
    ids = list(range(n)) + [n - 1] * pad
    kept = None    # the previous window's taps, by window slot
    for start in range(0, n, FRAME_STEP):
        new = ids[start:start + INFER_LEN] if kept is None else ids[start + OVERLAP:start + INFER_LEN]
        parts = [model.encode(preprocess(frames[new[i:i + block]], net_hw))
                 for i in range(0, len(new), block)]
        feats = [(torch.cat([p[j][0] for p in parts]), torch.cat([p[j][1] for p in parts]))
                 for j in range(len(parts[0]))]
        if kept is not None:
            kf = torch.tensor(KEYFRAMES, device=frames.device)
            feats = [(torch.cat([kt[kf], t]), torch.cat([kc[kf], c]))
                     for (kt, kc), (t, c) in zip(kept, feats)]
        kept = feats
        depth = model.decode(feats, *net_hw, INFER_LEN)
        yield F.interpolate(depth[:, None], size=(src_h, src_w), mode="bilinear",
                            align_corners=True)[:, 0]


@torch.no_grad()
def infer_video_depth(model, frames: torch.Tensor, input_size: int = 518,
                      metric: bool = False) -> torch.Tensor:
    """frames [N, H, W, 3] uint8 on the device -> stitched depth [N, H, W]
    float32 on the device."""
    n = frames.shape[0]
    out, refs = [], None
    w = torch.tensor([0.0] + [i / (INTERP_LEN - 1) for i in range(1, INTERP_LEN - 1)] + [1.0],
                     device=frames.device)[:, None, None]
    for depth in window_depths(model, frames, input_size):
        if refs is None:
            out.append(depth)
            refs = [depth[KEYFRAMES[0]], depth[KEYFRAMES[1]]]
            continue
        s, t = (1.0, 0.0) if metric else scale_and_shift(depth[:ALIGN_LEN], torch.stack(refs))
        aligned = torch.clamp_min(depth * s + t, 0.0)
        tail = out[-1][-INTERP_LEN:]
        out[-1] = torch.cat([out[-1][:-INTERP_LEN],
                             tail * (1 - w) + aligned[ALIGN_LEN:OVERLAP] * w])
        out.append(aligned[OVERLAP:])
        refs = [refs[0], aligned[KEYFRAMES[1]]]
    return torch.cat(out)[:n]
