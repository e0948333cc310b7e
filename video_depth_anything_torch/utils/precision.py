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
# int8-vs-fp32 budget (the JAX package's tests/test_quant.py), same terms.
INT8_MAX_ERR_FRAC = 0.08
INT8_MEAN_ERR_FRAC = 0.002


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


def flip_floor_report(candidate: np.ndarray, reference: np.ndarray,
                      floor_run: np.ndarray, cap: bool = True) -> dict:
    """Two int8 runs on identical activation scales, held to their flip floor.

    fp32 rounding that differs between the runs flips a few ``quant_act``
    roundings by a whole step, and the flips compound through the model.
    ``floor_run`` is the reference's own run with every absmax scaled by
    1 + 1e-6: what flips alone do. ``candidate`` must lie within twice that
    of ``reference`` in the aligned max and mean error (capped at the int8
    budget unless ``cap`` is False: where the floor itself exceeds the
    budget, the cap would reject the reference against itself) and in the
    unaligned relative L2 (which sees a scale or shift).
    """
    def measure(x):
        d = np.asarray(x, np.float64) - np.asarray(reference, np.float64)
        rep = precision_drift_report(x, reference)
        rep["rel_l2"] = float(np.linalg.norm(d) / max(np.linalg.norm(reference), 1e-30))
        rep["raw_max_err_frac"] = float(np.abs(d).max() / rep["depth_range"])
        return rep

    got, floor = measure(candidate), measure(floor_run)
    caps = (INT8_MAX_ERR_FRAC, INT8_MEAN_ERR_FRAC) if cap else (np.inf, np.inf)
    limit = {"max_err_frac": min(2 * floor["max_err_frac"], caps[0]),
             "mean_err_frac": min(2 * floor["mean_err_frac"], caps[1]),
             "rel_l2": 2 * floor["rel_l2"]}
    return {"got": got, "floor": floor, "limit": limit,
            "ok": all(got[k] < v for k, v in limit.items())}
