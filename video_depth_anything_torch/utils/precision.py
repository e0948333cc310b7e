"""Precision-drift measurement (the port's copy of the JAX package's
``utils/precision.py``).

Relative depth is defined up to an affine map, so low-precision drift is
measured after least-squares scale/shift alignment onto the fp32 oracle.
"""
from __future__ import annotations

import numpy as np

# bf16-vs-fp32 end-to-end drift budget, as fractions of the oracle's depth
# range after affine alignment.
MAX_ERR_FRAC = 0.05
MEAN_ERR_FRAC = 0.002


def synthetic_video(n: int = 50, hw: tuple[int, int] = (70, 98),
                    seed: int = 3) -> np.ndarray:
    """Moving smooth structure + mild sensor noise, uint8 [n, H, W, 3]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None, None]
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = (np.sin(x / 11 + t / 6) + np.cos(y / 9 - t / 8))[..., None]
    base = (base - base.min()) / (base.max() - base.min()) * 255
    return np.clip(base + rng.normal(0, 12, (n, *hw, 3)), 0, 255).astype(np.uint8)


def affine_align(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Least-squares (scale, shift) mapping pred -> target, applied."""
    p = pred.astype(np.float64).ravel()
    t = target.astype(np.float64).ravel()
    a = np.stack([p, np.ones_like(p)], axis=1)
    coef, *_ = np.linalg.lstsq(a, t, rcond=None)
    return (pred.astype(np.float64) * coef[0] + coef[1]).astype(np.float32)


def precision_drift_report(candidate: np.ndarray, oracle_fp32: np.ndarray) -> dict:
    """Max/mean aligned error as fractions of the oracle's depth range."""
    aligned = affine_align(candidate, oracle_fp32)
    rng = max(float(oracle_fp32.max() - oracle_fp32.min()), 1e-12)
    err = np.abs(aligned - oracle_fp32)
    return {
        "max_err_frac": float(err.max() / rng),
        "mean_err_frac": float(err.mean() / rng),
        "depth_range": rng,
    }
