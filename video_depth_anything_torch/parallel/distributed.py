"""Multi-process execution over ``torch.distributed`` (the port of the JAX
package's ``parallel/distributed.py``).

- ``initialize()`` joins the process group: over ``tcp://`` with explicit
  arguments, through ``env://`` when torchrun's ``RANK`` / ``WORLD_SIZE``
  are set (the counterpart of JAX's TPU cluster auto-discovery), and
  otherwise not at all (one process). The backend is NCCL on the card and
  gloo when the caller asks for the CPU; neither falls back to the other.
  ``backend="gloo"`` on the card runs gloo's collectives on CUDA tensors,
  which lets several ranks share one card.
- ``global_mesh(n_model)`` is one ``("data", "model")`` mesh over every
  rank.
- ``process_batch_bounds()`` is this rank's rows of a global batch: by its
  index on the mesh's data axis, so the ranks of one model group take the
  same rows.

Not copied: JAX's ``host_local_batch_to_global`` and
``host_replicated_to_global`` assemble global arrays from each host's
rows. A rank's tensors are already its own here; the collectives that JAX
leaves to its compiler are explicit where they are needed (the pipeline's
all_gather, the train step's gradient all_reduce).

NCCL takes one card per rank. A machine with one card therefore runs the
NCCL path at world size 1; more ranks share it only on gloo.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import data_rank, data_size, make_mesh


# The device kind ``initialize`` placed the process group on, with the
# group it was chosen for (a group joined later, without ``initialize``,
# does not inherit it).
_placed: tuple = (None, None)


def group_device_type() -> str:
    """The device type of the process group's collectives: the one
    ``initialize`` chose (``cuda`` for NCCL and for gloo with
    ``device="cuda"``, ``cpu`` for gloo on the CPU); for a group joined
    without it, ``cuda`` under NCCL and ``cpu`` otherwise."""
    group, kind = _placed
    if group is not None and group is dist.group.WORLD:
        return kind
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, backend: str | None = None) -> None:
    """Join the process group; idempotent. ``coordinator_address`` is
    ``host:port``. ``device``: ``cuda`` (the default, NCCL) or ``cpu``
    (gloo). ``backend="gloo"`` with ``cuda``: gloo on CUDA tensors, the
    card chosen as NCCL's would be (``make_mesh`` then makes a CUDA mesh).
    With no arguments and no torchrun environment, a no-op."""
    global _placed
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return
        init_method, world, rank = "env://", -1, -1
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize needs coordinator_address, num_processes and "
                             "process_id together")
        init_method = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass device='cpu' for gloo")
        backend = backend or "nccl"
    elif kind == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"device {device!r}: the process group runs on cuda or cpu")
    if (kind, backend) not in (("cuda", "nccl"), ("cuda", "gloo"), ("cpu", "gloo")):
        raise ValueError(f"backend {backend!r} does not run on {kind}")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _placed = (dist.group.WORLD, kind)
    if kind == "cuda":
        # This rank's card, chosen here once: every later placement
        # (mesh_device, the kernels' current stream) reads the current device.
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank() % torch.cuda.device_count())))


def global_mesh(n_model: int = 1):
    """The ``("data", "model")`` mesh over every rank of the process group,
    ``n_model`` wide on the model axis, on the group's device."""
    return make_mesh(n_model=n_model)


def process_batch_bounds(global_batch: int, mesh=None) -> tuple[int, int]:
    """[start, stop) rows of the global batch owned by this rank: by its
    index on ``mesh``'s data axis (every rank of a model group gets the
    same rows); without a mesh, by its rank in the process group."""
    if mesh is not None:
        n, p = data_size(mesh), data_rank(mesh)
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
        p = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n != 0:
        raise ValueError(
            f"multi-host feeding needs the global batch (= mesh data-axis "
            f"chunk, {global_batch}) to be a multiple of the process count "
            f"({n}); use a mesh with data >= {n} processes x its per-chip "
            f"batch, or run single-host")
    per = global_batch // n
    return p * per, (p + 1) * per
