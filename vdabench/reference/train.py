"""The training step in plain PyTorch, float32: the reference the train
cell's first steps are held to.

The fine-tuning of the video model as the configuration states it
(``configs/config.yaml`` of the repository's training: frozen encoder,
every floating tensor of the head trained, the loss of the Video Depth
Anything paper): the scale-and-shift-invariant loss with a per-frame
least-squares fit, plus 10 times the temporal gradient matching loss on
static pixels (|gt[t+1] - gt[t]| < 0.05); AdamW (beta 0.9 / 0.999, eps
1e-8, decoupled weight decay on every trained tensor) at a cosine
learning rate that decays over epochs x steps per epoch to ``eta_min``.
The gradient is autograd's, of the head's tensors passed in by
``functional_call``. Written from the loss's definition, not from the
program's code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.func import functional_call

from . import model as ref_model


def ssi_lstsq(pred, gt, mask, eps: float = 1e-8):
    """Per frame: gt ~ s * pred + t by masked least squares, then the mean
    squared residual over the frame's valid pixels; the mean over frames."""
    m = mask.float().flatten(2)
    p, g = pred.flatten(2), gt.flatten(2)
    n = m.sum(-1, keepdim=True).clamp_min(1.0)
    mp, mg = (p * m).sum(-1, keepdim=True) / n, (g * m).sum(-1, keepdim=True) / n
    dp, dg = p - mp, g - mg
    s = (dp * dg * m).sum(-1, keepdim=True) / ((dp * dp * m).sum(-1, keepdim=True) + eps)
    res = (s * p + (mg - s * mp) - g) ** 2 * m
    return (res.sum(-1) / n[..., 0]).mean()


def tgm(pred, gt, mask, thresh: float = 0.05):
    """Over consecutive frame pairs: the mean, over pixels static in gt and
    valid in both frames, of | |pred[t+1] - pred[t]| - |gt[t+1] - gt[t]| |;
    a pair with no such pixel adds 0; the mean over pairs and clips."""
    dp = (pred[:, 1:] - pred[:, :-1]).abs()
    dg = (gt[:, 1:] - gt[:, :-1]).abs()
    static = ((dg < thresh) & mask[:, 1:].bool() & mask[:, :-1].bool()).float()
    num = ((dp - dg).abs() * static).flatten(2).sum(-1)
    cnt = static.flatten(2).sum(-1)
    return torch.where(cnt > 0, num / cnt.clamp_min(1.0), torch.zeros_like(num)).mean()


def loss(pred, gt, mask, ratio_ssi: float = 1.0, ratio_tgm: float = 10.0):
    m = mask.float()
    return ratio_ssi * ssi_lstsq(pred * m, gt * m, mask) + ratio_tgm * tgm(pred * m, gt * m, mask)


def cosine_lr(tc: dict, count: int) -> float:
    total = max(tc["epochs"] * tc["steps_per_epoch"], 1)
    alpha = tc["eta_min"] / tc["learning_rate"]
    cos = 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))
    return tc["learning_rate"] * ((1.0 - alpha) * cos + alpha)


def depth(model, head: dict, video: torch.Tensor, block: int = 4) -> torch.Tensor:
    """video [B, T, H, W, 3] normalised -> depth [B, T, H, W]: the frozen
    encoder without a gradient (in blocks of frames), the head on the
    tensors ``head`` (differentiable)."""
    b, t, h, w, _ = video.shape
    x = video.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    with torch.no_grad():
        parts = [model.encode(x[i:i + block]) for i in range(0, b * t, block)]
    feats = [(torch.cat([p[j][0] for p in parts]), torch.cat([p[j][1] for p in parts]))
             for j in range(len(parts[0]))]
    p = model.patch
    tensors = {k: ref_model.rounded(v) for k, v in head.items()}
    out = functional_call(model.head, tensors, (feats, h // p, w // p, t))
    out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=True)
    return F.relu(out)[:, 0].reshape(b, t, h, w)


def follow(model, batches, tc: dict, steps: int = 3) -> dict:
    """``steps`` AdamW steps of the head on ``batches`` from the model's
    own weights -> {"losses": [...], "grads": {name: first gradient},
    "change": {name: tensor after the steps - before}}."""
    head = {k: v.detach().clone().requires_grad_(True)
            for k, v in model.head.state_dict().items() if v.is_floating_point()}
    start = {k: v.detach().clone() for k, v in head.items()}
    mom = {k: torch.zeros_like(v) for k, v in head.items()}
    vel = {k: torch.zeros_like(v) for k, v in head.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, tc["weight_decay"]
    out = {"losses": [], "grads": None}
    for i in range(steps):
        batch = batches[i]
        total = loss(depth(model, head, batch["video"]), batch["gt"], batch["mask"],
                     tc["ratio_ssi"], tc["ratio_tgm"])
        grads = torch.autograd.grad(total, list(head.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(head.items(), grads)}
        out["losses"].append(float(total.detach()))
        if out["grads"] is None:
            out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        lr = cosine_lr(tc, i)
        with torch.no_grad():
            for k, p in head.items():
                g = grads[k]
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * wd)
                denom = (vel[k] / (1 - b2 ** (i + 1))).sqrt_().add_(eps)
                p.addcdiv_(mom[k], denom, value=-lr / (1 - b1 ** (i + 1)))
    out["change"] = {k: (head[k].detach() - start[k]) for k in head}
    return out
