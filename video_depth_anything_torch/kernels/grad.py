"""The forward-only kernels refuse to run where autograd would record them.

A kernel launched through ctypes writes into a tensor autograd knows
nothing of: its output has no ``grad_fn``, so a gradient would stop there
without a word. K1 and K3-K6 have no backward, so their wrappers raise
instead (as differentiating a ``pallas_call`` without a VJP rule fails in
the JAX package). Only K2 has one (``temporal_attention.py``). The check
holds on the CPU as well, where the plain versions could differentiate,
so that a CPU run never trains a function the card would not.
"""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor | None) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: its output would silently drop the gradient. "
            f"Call it under torch.no_grad() or on tensors that do not require grad.")
