"""Training losses (the port of the JAX package's ``training/losses.py``).

pred, gt, mask: [B, T, H, W] disparity, mask bool or 0/1. Every loss is a
masked reduction in plain PyTorch with the JAX functions' values and the
derivatives JAX's autodiff takes at their kinks:

  - ``abs`` is ``_abs``: derivative +1 at 0 (``jnp.abs``), where
    ``torch.abs`` gives 0. The median loss hits it at each row's median
    pixel, the MAE and TGM losses where a residual is exactly 0.
  - the median is the lower one, ``sorted[(count - 1) // 2]``, from a
    stable sort (``jnp.sort``), so a tie sends the gradient to the same
    element; a row with no valid pixel has median 0 and scale ``eps``.
"""
from __future__ import annotations

import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at x == 0, as ``jnp.abs`` has."""
    return torch.where(x >= 0, x, -x)


def _masked_median(x_flat: torch.Tensor, mask_flat: torch.Tensor):
    """Per-row lower median over the masked entries of x_flat [R, M]
    -> (median [R], count [R])."""
    vals = torch.where(mask_flat, x_flat, torch.full_like(x_flat, torch.inf))
    vals = torch.sort(vals, dim=1, stable=True).values
    count = mask_flat.sum(dim=1)
    idx = (count - 1).clamp_min(0) // 2
    med = torch.gather(vals, 1, idx[:, None])[:, 0]
    return torch.where(count > 0, med, torch.zeros_like(med)), count


def ssi_loss_median(pred, gt, mask, eps: float = 1e-8):
    """Loss_ssi, median / MAD variant: both maps normalised per frame by
    masked median and mean absolute deviation; the squared difference
    averaged over W per (B, T, H) row, then over everything."""
    b, t, h, w = pred.shape
    m = mask.bool()
    mflat = m.reshape(b * t, h * w)

    def norm(d):
        flat = d.reshape(b * t, h * w)
        med, count = _masked_median(flat, mflat)
        absdiff = _abs(flat - med[:, None]) * mflat
        denom = count.clamp_min(1)
        scale = absdiff.sum(dim=1) / denom + eps
        scale = torch.where(count > 0, scale, torch.full_like(scale, eps))
        return ((flat - med[:, None]) / scale[:, None]).reshape(b, t, h, w)

    rho = (norm(pred) - norm(gt)) ** 2
    rho = torch.where(m, rho, torch.zeros_like(rho))
    valid_w = m.sum(dim=-1).clamp_min(1).to(rho.dtype)
    return (rho.sum(dim=-1) / valid_w).mean()


def ssi_loss_lstsq(pred, gt, mask, eps: float = 1e-8):
    """Loss_ssi, per-frame least-squares (scale, shift) variant: the loss
    of the live training loop."""
    b, t, h, w = pred.shape
    flat_d = pred.reshape(b * t, h * w)
    flat_g = gt.reshape(b * t, h * w)
    flat_m = mask.to(pred.dtype).reshape(b * t, h * w)
    count = flat_m.sum(dim=1, keepdim=True).clamp_min(1.0)
    mu_d = (flat_d * flat_m).sum(dim=1, keepdim=True) / count
    mu_g = (flat_g * flat_m).sum(dim=1, keepdim=True) / count
    dd = flat_d - mu_d
    gg = flat_g - mu_g
    num = ((dd * gg) * flat_m).sum(dim=1, keepdim=True)
    den = ((dd * dd) * flat_m).sum(dim=1, keepdim=True)
    s = num / (den + eps)
    shift = mu_g - s * mu_d
    aligned = (s * flat_d + shift).reshape(b, t, h, w)
    rho = (aligned - gt) ** 2
    rho = torch.where(mask.bool(), rho, torch.zeros_like(rho))
    valid = mask.to(pred.dtype).reshape(b, t, -1).sum(dim=2).clamp_min(1.0)
    return (rho.reshape(b, t, -1).sum(dim=2) / valid).mean()


def ssi_mse_loss(pred, gt, mask, eps: float = 1e-7):
    """Loss_ssi_mse, the sequence-level MAE variant."""
    b = pred.shape[0]
    m = mask.to(pred.dtype).reshape(b, -1)
    d = pred.reshape(b, -1)
    g = gt.reshape(b, -1)
    count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
    mu_d = (d * m).sum(dim=1, keepdim=True) / count
    mu_g = (g * m).sum(dim=1, keepdim=True) / count
    num = (((d - mu_d) * (g - mu_g)) * m).sum(dim=1, keepdim=True)
    den = (((d - mu_d) ** 2) * m).sum(dim=1, keepdim=True)
    s = num / (den + eps)
    shift = mu_g - s * mu_d
    residual = _abs(s * d + shift - g) * m
    return (residual.sum(dim=1, keepdim=True) / (2.0 * count)).mean()


def tgm_loss(pred, gt, mask, static_thresh: float = 0.05):
    """Loss_tgm, temporal gradient matching on static regions, over the
    (B, T - 1) frame pairs; a pair with no static pixel contributes 0."""
    m = mask.bool()
    d_diff = _abs(pred[:, 1:] - pred[:, :-1])
    g_diff = _abs(gt[:, 1:] - gt[:, :-1])
    valid = m[:, 1:] & m[:, :-1]
    static = (g_diff < static_thresh) & valid
    diff = _abs(d_diff - g_diff)
    diff = torch.where(static, diff, torch.zeros_like(diff))
    b, tm1 = diff.shape[0], diff.shape[1]
    num_static = static.reshape(b, tm1, -1).sum(dim=2)
    pair_sum = diff.reshape(b, tm1, -1).sum(dim=2)
    pair_loss = torch.where(num_static > 0, pair_sum / num_static.clamp_min(1),
                            torch.zeros_like(pair_sum))
    return (pair_loss.sum(dim=1) / tm1).mean()


def combined_loss(pred, gt, mask, ratio_ssi=1.0, ratio_tgm=10.0,
                  ssi_variant: str = "lstsq"):
    """ratio_ssi * SSI + ratio_tgm * TGM on pred * mask and gt * mask
    -> (total, {"ssi", "tgm"})."""
    m = mask.to(pred.dtype)
    ssi_fn = ssi_loss_lstsq if ssi_variant == "lstsq" else ssi_loss_median
    l_ssi = ssi_fn(pred * m, gt * m, mask)
    l_tgm = tgm_loss(pred * m, gt * m, mask)
    return ratio_ssi * l_ssi + ratio_tgm * l_tgm, {"ssi": l_ssi, "tgm": l_tgm}
