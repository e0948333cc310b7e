"""Device mesh and data-parallel placement over ``torch.distributed`` (the
port of the JAX package's ``parallel/mesh.py``).

A mesh has the axes ``("data", "model")`` and one device per rank. The
data axis is what is ported: windows at inference and the batch in
training are split over it, and every rank holds the whole model
(``shard_params`` broadcasts it from rank 0). The model axis (tensor
parallelism: JAX's ``param_sharding_rules`` over q / k / v, the MLPs and
the motion modules) is ROADMAP queue 1's tensor-parallel item; a mesh
with ``n_model > 1`` is refused until then.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

TENSOR_PARALLEL_NOT_PORTED = (
    "the mesh's model axis (tensor parallelism) is not ported yet: ROADMAP queue 1, "
    "the tensor-parallel item (param_sharding_rules over the fused qkv / w12 columns, "
    "local heads, local tensors into the kernels, the int8 w_i8 / ws leaves)")


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ``DeviceMesh`` of shape (n_data, n_model) over every rank of the
    process group, on the group's device (``cuda`` under NCCL, ``cpu``
    under gloo). n_data defaults to world size // n_model."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_model != 1:
        raise NotImplementedError(TENSOR_PARALLEL_NOT_PORTED)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    return init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                            (n_data, n_model), mesh_dim_names=("data", "model"))


def data_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("data"))


def require_data_only(mesh) -> None:
    """Refuse a mesh whose model axis is larger than 1."""
    if mesh.size(mesh.mesh_dim_names.index("model")) != 1:
        raise NotImplementedError(TENSOR_PARALLEL_NOT_PORTED)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: on a CUDA mesh the card that
    ``distributed.initialize`` made current, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def broadcast_(tensors, mesh) -> None:
    """Every tensor of ``tensors`` set, in place, to rank 0's values over
    the data axis. A tensor off the mesh's device (AdamW's step counter on
    the CPU under NCCL) travels through a device copy."""
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    device = mesh_device(mesh)
    for t in tensors:
        if t.device.type == device.type:
            dist.broadcast(t.data, src=src, group=group)
        else:
            buf = t.detach().to(device)
            dist.broadcast(buf, src=src, group=group)
            t.data.copy_(buf)


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replicate ``model`` over the mesh (the data axis; n_model is 1):
    every parameter and buffer broadcast from rank 0, in place."""
    broadcast_(model.state_dict(keep_vars=True).values(), mesh)
    return model


def shard_batch(batch, mesh):
    """This rank's rows of ``batch`` (a tensor or array, or a dict of them)
    on the data axis: contiguous, the batch a multiple of the axis."""
    from .distributed import process_batch_bounds

    def take(x):
        lo, hi = process_batch_bounds(x.shape[0])
        return x[lo:hi]

    require_data_only(mesh)
    return {k: take(v) for k, v in batch.items()} if isinstance(batch, dict) else take(batch)
