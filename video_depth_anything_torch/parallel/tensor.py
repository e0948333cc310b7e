"""The mesh's model axis: tensor parallelism with explicit collectives.

Where the JAX package annotates shardings and leaves the communication to
GSPMD, the port follows Megatron: a block split over ``"model"`` holds
this rank's shard as plain local tensors (its heads' q, k and v, its part
of the MLP hidden), so the kernels, called through ctypes on
``data_ptr()``, see ordinary tensors at the local head count. A split
block starts with ``copy_to_model`` and ends in ``reduce_from_model``:

- ``copy_to_model(x, axis)``: the identity forward; the backward sums the
  gradient over the model group (each rank's branch sees only its heads,
  so without the sum everything upstream of a column-split product, the
  norms, the head's projections and refine convs, would get a partial
  gradient);
- ``reduce_from_model(x, axis)``: the forward sums every rank's partial
  product of a row-split layer (in fp32 for floats); the backward is the
  identity;
- ``max_over_model(x, axis)``: a MAX over the group, for the calibration
  absmax of an activation that is split.

Every collective is one ``all_reduce``, so every rank of a model group
gets the same bytes. A sum of floats runs in fp32: a bf16 partial is
widened first, so a split product is rounded to bf16 once, after the sum,
as the unsplit product is (``reduce_from_model`` returns the fp32 sum; the
caller adds the bias and rounds). An int32 sum is exact as it is.
``axis`` None (no model axis, or a block left whole) makes each of them
the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class ModelAxis:
    """This rank's model group (``group``, None for the default group),
    its ``size`` and this rank's index in it (``rank``). A deepcopy of a
    split module keeps the same axis: a process group is not copied."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def _sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over the model group, in fp32 for a float tensor (the
    result stays fp32), in its own dtype for an integer one."""
    return _all_reduce(x.float() if x.is_floating_point() else x, axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.dtype = x.dtype
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    if axis is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, axis)
    return _sum(x, axis)


def max_over_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    return x if axis is None else _all_reduce(x, axis, dist.ReduceOp.MAX)
