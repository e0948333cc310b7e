"""Depth metrics in NumPy (the port's copy of the JAX package's
``benchmark/metrics.py``): per-frame masked sums over the last two axes
divided by the per-frame valid count, then the mean over frames."""
from __future__ import annotations

import numpy as np


def _n(valid_mask, shape):
    if valid_mask is None:
        return shape[-1] * shape[-2]
    return valid_mask.sum((-1, -2))


def abs_relative_difference(output, target, valid_mask=None):
    d = np.abs(output - target) / target
    if valid_mask is not None:
        d = np.where(valid_mask, d, 0)
    return (d.sum((-1, -2)) / _n(valid_mask, output.shape)).mean()


def squared_relative_difference(output, target, valid_mask=None):
    d = np.abs(output - target) ** 2 / target
    if valid_mask is not None:
        d = np.where(valid_mask, d, 0)
    return (d.sum((-1, -2)) / _n(valid_mask, output.shape)).mean()


def rmse_linear(output, target, valid_mask=None):
    diff = output - target
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0)
    mse = (diff ** 2).sum((-1, -2)) / _n(valid_mask, output.shape)
    return np.sqrt(mse).mean()


def rmse_log(output, target, valid_mask=None):
    diff = np.log(output) - np.log(target)
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0)
    mse = (diff ** 2).sum((-1, -2)) / _n(valid_mask, output.shape)
    return np.sqrt(mse).mean()


def log10(output, target, valid_mask=None):
    if valid_mask is not None:
        return np.abs(np.log10(output[valid_mask]) - np.log10(target[valid_mask])).mean()
    return np.abs(np.log10(output) - np.log10(target)).mean()


def threshold_percentage(output, target, threshold_val, valid_mask=None):
    ratio = np.maximum(output / target, target / output)
    bit = (ratio < threshold_val).astype(np.float64)
    if valid_mask is not None:
        bit = np.where(valid_mask, bit, 0)
    return (bit.sum((-1, -2)) / _n(valid_mask, output.shape)).mean()


def delta1_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25, valid_mask)


def delta2_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 2, valid_mask)


def delta3_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 3, valid_mask)


def i_rmse(output, target, valid_mask=None):
    diff = 1.0 / output - 1.0 / target
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0)
    mse = (diff ** 2).sum((-1, -2)) / _n(valid_mask, output.shape)
    return np.sqrt(mse).mean()


def silog_rmse(depth_pred, depth_gt, valid_mask=None):
    diff = np.log(depth_pred) - np.log(depth_gt)
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0)
    n = _n(valid_mask, depth_gt.shape)
    first = (diff ** 2).sum((-1, -2)) / n
    second = diff.sum((-1, -2)) ** 2 / (n ** 2)
    return np.sqrt((first - second).mean()) * 100


EVAL_METRICS = {
    "abs_relative_difference": abs_relative_difference,
    "rmse_linear": rmse_linear,
    "delta1_acc": delta1_acc,
}
