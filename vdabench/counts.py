"""The yardstick: the card's published peaks, the operations and bytes a
kernel's work needs, and the model FLOPs of a cell's work.

Peaks: NVIDIA H100 SXM, dense, at the 700 W power limit: 989e12 bf16
FLOP/s on the tensor cores, 3.35e12 bytes/s of HBM.

Bytes count each input once and each output once, whatever a kernel reads
again; operations count the products the algorithm needs (2 per
multiply-add), not the exponentials.
"""
from __future__ import annotations

import contextlib

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the tensor-core
    peak or bytes at the HBM rate, whichever is longer."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1(frames: int, tokens: int, dim: int, heads: int) -> tuple[float, float]:
    """(operations, bytes) of K1, spatial attention over ``tokens`` tokens
    of ``frames`` frames, ``dim`` channels in ``heads`` heads: QK^T and PV
    (2 * tokens^2 * head dim each); q, k and v read, o written, bf16."""
    ops = frames * heads * 4.0 * tokens * tokens * (dim // heads)
    return ops, 4.0 * frames * tokens * dim * BF16


def k2(pixels: int, frames: int, dim: int) -> tuple[float, float]:
    """(operations, bytes) of K2, temporal attention over ``frames`` frames
    of ``pixels`` pixels of ``dim`` channels: QK^T and PV; q, k, v read, o
    written."""
    return 4.0 * pixels * frames * frames * dim, 4.0 * pixels * frames * dim * BF16


def k2_backward(pixels: int, frames: int, dim: int) -> tuple[float, float]:
    """(operations, bytes) of the K2 backward: S recomputed, dP = dO V^T,
    dV = P^T dO, dQ = dS K, dK = dS^T Q (2 * frames^2 * dim each); q, k, v
    and do read, dq, dk and dv written."""
    return 10.0 * pixels * frames * frames * dim, 7.0 * pixels * frames * dim * BF16


def motion_shapes(config: dict, ph: int, pw: int) -> list[tuple[int, int]]:
    """(pixels per frame, channels) of the four motion modules at a patch
    grid (ph, pw): layer_3 at the grid, layer_4 at half of it (stride-2
    conv), path_4 at the grid, path_3 at twice it."""
    oc, f = config["out_channels"], config["features"]
    return [(ph * pw, oc[2]), (-(-ph // 2) * -(-pw // 2), oc[3]), (ph * pw, f),
            (4 * ph * pw, f)]


def k2_head(config: dict, ph: int, pw: int, windows: int, frames: int, backward=False):
    """(operations, bytes) of every K2 call (or its backward) of the head
    on ``windows`` windows of ``frames`` frames: two attention blocks in
    each of the four motion modules."""
    fn = k2_backward if backward else k2
    ops = nbytes = 0.0
    for px, c in motion_shapes(config, ph, pw):
        o, b = fn(windows * px, frames, c)
        ops, nbytes = ops + 2 * o, nbytes + 2 * b
    return ops, nbytes


def encoder_k1(config: dict, frames: int, ph: int, pw: int) -> tuple[float, float]:
    """(operations, bytes) of K1 in the encoder's blocks that run (up to
    the last tap) on ``frames`` frames at a patch grid (ph, pw)."""
    blocks = max(config["taps"]) + 1
    ops, nbytes = k1(frames, 1 + ph * pw, config["embed_dim"], config["num_heads"])
    return blocks * ops, blocks * nbytes


@contextlib.contextmanager
def _counting():
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        yield mode


def model_flops(config: dict, net_hw, frames: int, train: bool = False) -> dict:
    """FLOPs of the reference model (``reference/model.py``) on meta tensors
    at the network size ``net_hw``, counted by torch's FlopCounterMode:
    ``encoder`` per frame, ``head`` per window of ``frames`` frames, and
    with ``train`` ``head_backward`` per window (the gradient of the head's
    input and of its weights)."""
    from .reference.model import VideoDepthAnything

    with torch.device("meta"):
        model = VideoDepthAnything(config)
        x = torch.zeros(1, 3, *net_hw)
    with torch.no_grad(), _counting() as enc:
        model.encode(x)
    p = config["patch_size"]
    ph, pw = net_hw[0] // p, net_hw[1] // p
    d = config["embed_dim"]
    with torch.device("meta"):
        feats = [(torch.zeros(frames, ph * pw, d), torch.zeros(frames, d))
                 for _ in config["taps"]]
    out = {"encoder": float(enc.get_total_flops())}
    if not train:
        with torch.no_grad(), _counting() as head:
            model.decode(feats, *net_hw, frames)
        out["head"] = float(head.get_total_flops())
        return out
    with _counting() as head:
        depth = model.decode(feats, *net_hw, frames)
    out["head"] = float(head.get_total_flops())
    with _counting() as back:
        depth.sum().backward()
    out["head_backward"] = float(back.get_total_flops())
    return out
