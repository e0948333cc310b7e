"""Validation metrics (the port's copy of the JAX package's
``training/validate.py``).

Per clip: a clip-level float64 least-squares fit of predicted disparity
to GT disparity (valid = 1e-3 < gt < 80 m), inverted to depth with no
clamp at the maximum depth, AbsRel and delta1 over the valid frames, and
the symmetric TAE from the per-frame poses and intrinsics.
"""
from __future__ import annotations

import numpy as np

from ..benchmark import metrics as bm
from ..benchmark.tae import tae_pair

MAX_DEPTH = 80.0


def metric_val(pred_disp: np.ndarray, gt_depth: np.ndarray,
               poses: np.ndarray, ks: np.ndarray):
    """pred_disp, gt_depth: [T,H,W]; poses [T,4,4]; ks [T,3,3] ->
    (absrel, delta1, tae)."""
    valid = (gt_depth > 1e-3) & (gt_depth < MAX_DEPTH)
    gt_disp = 1.0 / (gt_depth[valid].reshape(-1, 1).astype(np.float64) + 1e-8)
    pred = np.clip(pred_disp, 1e-3, None)
    a = np.concatenate([pred[valid].reshape(-1, 1).astype(np.float64),
                        np.ones((int(valid.sum()), 1))], axis=1)
    scale, shift = np.linalg.lstsq(a, gt_disp, rcond=None)[0].ravel()
    aligned = np.clip(float(scale) * pred + float(shift), 1e-3, None)
    depth = 1.0 / aligned  # no max clamp (train.py:76-80)

    frame_ok = valid.sum((-1, -2)) > 0
    d, g, v = depth[frame_ok], gt_depth[frame_ok], valid[frame_ok]
    absrel = bm.abs_relative_difference(d, g, v)
    delta1 = bm.delta1_acc(d, g, v)

    err = 0.0
    n = d.shape[0]
    for i in range(n - 1):
        t_2_1 = np.linalg.inv(poses[i + 1]) @ poses[i]
        err += tae_pair(d[i], d[i + 1], t_2_1[:3, :3], t_2_1[:3, 3],
                        ks[i], v[i + 1])
        t_1_2 = np.linalg.inv(t_2_1)
        err += tae_pair(d[i + 1], d[i], t_1_2[:3, :3], t_1_2[:3, 3],
                        ks[i], v[i])
    tae = err / (2 * (n - 1)) if n > 1 else 0.0
    return float(absrel), float(delta1), float(tae)
