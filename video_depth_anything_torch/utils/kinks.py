"""Share one evaluation's kink decisions with another, to compare gradients.

The train step's loss is piecewise smooth: every ReLU (``ops/nn.py::relu``)
and every |.| of the losses (``training/losses.py::_abs``) picks a side by
the sign of its input. An input within rounding of 0 may take one side on
the card and the other on the CPU, and the gradient of every tensor
upstream then differs by a whole term (one pixel's, many times the
rounding of the rest of the sum). ``record`` keeps the sides one
evaluation took; ``replay`` makes another evaluation take the same ones, so
the two gradients are of the same smooth piece and differ by rounding only.

    log = []
    with kinks.record(log):
        card_step()
    flips = []
    with kinks.replay(log, flips):
        cpu_step()
    # flips: per kink, (entries whose side was moved, their largest |x|
    # over the map's largest |x|)

A replayed ReLU is ``x * w`` with w = 1, 1/2 (a tie: JAX's derivative) or
0 from the recorded side; a replayed |x| is ``x * s`` with s = +-1. Where
the sides agree the values are those of the plain functions; where one was
moved, the value is off by that input's |x|, which ``flips`` reports.
"""
from __future__ import annotations

import contextlib

import torch

from ..ops import nn as vnn
from ..training import losses


@contextlib.contextmanager
def record(log: list):
    """Append each kink's side (int8 sign, on the input's device) to ``log``;
    the values computed are untouched."""
    relu, absval = vnn.relu, losses._abs

    def relu_rec(x):
        log.append(torch.sign(x.detach()).to(torch.int8))
        return relu(x)

    def abs_rec(x):
        log.append(torch.where(x.detach() >= 0, 1, -1).to(torch.int8))
        return absval(x)

    vnn.relu, losses._abs = relu_rec, abs_rec
    try:
        yield
    finally:
        vnn.relu, losses._abs = relu, absval


@contextlib.contextmanager
def replay(log: list, flips: list):
    """Take the sides in ``log``, in order; append (moved entries, their
    largest |x| over the map's largest |x|) per kink to ``flips``. Raises
    if the kinks are not those recorded, one for one."""
    relu, absval = vnn.relu, losses._abs
    sides = iter(log)

    def side(x, own):
        s = next(sides, None)
        if s is None or s.shape != x.shape:
            raise RuntimeError("replayed kinks differ from the recorded ones")
        s = s.to(x.device)
        moved = (s > 0) != own
        a = x.detach().abs()
        top = a.max().item() if a.numel() else 0.0
        flips.append((int(moved.sum()), a[moved].max().item() / top if moved.any() else 0.0))
        return s.to(x.dtype)

    def relu_rep(x):
        return x * (side(x, x > 0) + 1) / 2

    def abs_rep(x):
        return x * side(x, x >= 0)

    vnn.relu, losses._abs = relu_rep, abs_rep
    try:
        yield
    finally:
        vnn.relu, losses._abs = relu, absval
    if next(sides, None) is not None:
        raise RuntimeError("replayed kinks differ from the recorded ones")
