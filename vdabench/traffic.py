"""The generator of inference traffic: a host pool of video frames and the
closed-loop sequence of clips cut from it, both from the seed.

A traffic file (``traffic/<name>.json``, mode ``infer``) gives:

- ``source_hw``: the frames' height and width (uint8 RGB);
- ``pool_frames``: the frames of the pool, made on the device and copied
  to host memory once, in set-up;
- ``scene``: the pool's content: a ``grid`` of random values per channel
  that drifts by ``drift`` (a random walk) from frame to frame, resized
  bilinearly to the source size, plus ``noise`` (uint8 steps) of texture;
- ``clip_frames`` [lo, hi] and ``lengths``: the clip lengths, ``lengths``
  values evenly spaced from lo to hi, sent in cycles of one clip of each.
  Every seed sends the same set in every cycle, in another order, and a
  window is whole cycles, so that the seed changes which frames are sent
  and in what order, never how much work;
- ``warmup_lengths``: the clip lengths run once in set-up, which between
  them build every shape the cell's clips use;
- ``input_size``, ``windows_per_batch``: the arguments of
  ``infer_video_depth``;
- ``clients``: 1, a closed loop (the next clip is sent when the last one
  has come back).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F


def lengths(traffic: dict) -> list[int]:
    lo, hi = traffic["clip_frames"]
    return [int(round(x)) for x in np.linspace(lo, hi, traffic["lengths"])]


def cycles(traffic: dict, seed: int):
    """Endless cycles of the clips, from the seed: each a list of
    (ordinal, start, length), one clip of every length."""
    rng = np.random.default_rng([seed, 1])
    lens = lengths(traffic)
    ordinal = itertools.count()
    while True:
        cycle = []
        for n in rng.permutation(lens):
            start = int(rng.integers(0, traffic["pool_frames"] - n + 1))
            cycle.append((next(ordinal), start, int(n)))
        yield cycle


def clips(traffic: dict, seed: int):
    """The clips of ``cycles``, one after another."""
    for cycle in cycles(traffic, seed):
        yield from cycle


def check_sample(workload: dict, seed: int) -> set[int]:
    """The ordinals of the clips whose depths are compared with the
    reference: ``check.clips`` of the first ``check.from_first``, drawn from
    the seed."""
    chk = workload["check"]
    rng = np.random.default_rng([seed, 2])
    return {int(i) for i in rng.choice(chk["from_first"], chk["clips"], replace=False)}


@torch.no_grad()
def frame_pool(traffic: dict, seed: int, device, block: int = 32) -> np.ndarray:
    """[pool_frames, H, W, 3] uint8 in host memory, made on ``device``."""
    n = traffic["pool_frames"]
    h, w = traffic["source_hw"]
    sc = traffic["scene"]
    gh, gw = sc["grid"]
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(1, 3, gh, gw, generator=gen, device=device)
    steps = sc["drift"] * torch.randn(n, 3, gh, gw, generator=gen, device=device)
    field = base + steps.cumsum(0)
    pool = np.empty((n, h, w, 3), np.uint8)
    for i in range(0, n, block):
        x = F.interpolate(field[i:i + block], size=(h, w), mode="bilinear", align_corners=True)
        x = 127.5 + 60.0 * x + sc["noise"] * torch.randn(x.shape, generator=gen, device=device)
        pool[i:i + block] = x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return pool
