"""Cross-window depth stitching in fp32, on the device.

Per window, a closed-form centered 2x2 least-squares fit aligns the
window's first ALIGN_LEN depth frames to the running references (frame 0
and the previous window's keyframe-12 output); the 8 overlap frames are
cross-faded between the previous window's tail and the aligned window. The
metric model pins scale, shift = 1, 0 but keeps the clamp and cross-fade.
The port of the JAX package's ``pipeline/stitch.py``.

Carry: (ref0 [H, W], ref1 [H, W], tail8 [8, H, W]).
"""
from __future__ import annotations

import torch

from ..config import ALIGN_LEN, INTERP_LEN, KEYFRAMES, OVERLAP
from ..utils import profiling


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor):
    """Affine lstsq in the centered (covariance) form, stable in fp32."""
    p, t = prediction.float(), target.float()
    mp, mt = p.mean(), t.mean()
    dp = p - mp
    var_p = (dp * dp).mean()
    cov = (dp * (t - mt)).mean()
    ok = var_p > 0
    one = torch.ones_like(var_p)
    scale = torch.where(ok, cov / torch.where(ok, var_p, one), one)
    shift = torch.where(ok, mt - scale * mp, torch.zeros_like(mp))
    return scale, shift


def fade_weights(device) -> torch.Tensor:
    """Cross-fade weights [0, 1/7, ..., 6/7, 1]."""
    step = 1.0 / (INTERP_LEN - 1)
    w = [0.0] + [i * step for i in range(1, INTERP_LEN - 1)] + [1.0]
    return torch.tensor(w, dtype=torch.float32, device=device)[:, None, None]


def stitch_first(depths0: torch.Tensor):
    """Window 0: emitted raw (frames 0..23); seeds the references."""
    carry = (depths0[0], depths0[KEYFRAMES[1]], depths0[-INTERP_LEN:])
    return carry, depths0[: OVERLAP + 14]


def stitch_step(carry, depths: torch.Tensor, metric: bool = False):
    """One later window [32, H, W] fp32 -> (carry, 22 finalised frames)."""
    ref0, ref1, tail8 = carry
    if metric:
        aligned = torch.clamp_min(depths, 0.0)
    else:
        scale, shift = compute_scale_and_shift(depths[:ALIGN_LEN],
                                               torch.stack([ref0, ref1]))
        aligned = torch.clamp_min(depths * scale + shift, 0.0)
    with profiling.span("vda.pipeline.wait"):    # a pageable copy: waits for the card's queue
        w = fade_weights(depths.device)
    faded = tail8 * (1.0 - w) + aligned[ALIGN_LEN:OVERLAP] * w
    emit = torch.cat([faded, aligned[OVERLAP:OVERLAP + 14]], dim=0)
    return (ref0, aligned[KEYFRAMES[1]], aligned[-INTERP_LEN:]), emit
