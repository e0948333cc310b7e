"""Device mesh, data-parallel placement and the model axis's sharding rules
over ``torch.distributed`` (the port of the JAX package's
``parallel/mesh.py``).

A mesh has the axes ``("data", "model")`` and one device per rank; rank
``d * n_model + m`` sits at (d, m), so a model group is ``n_model``
consecutive ranks. Windows at inference and the batch in training are
split over "data" (``shard_batch``, the pipeline's ``DataAxis``); the
ranks of one model group take the same rows.

The model axis is tensor parallelism in Megatron's form
(``parallel/tensor.py``): ``shard_params`` broadcasts rank 0's weights
over the whole mesh and keeps this rank's shard of every tensor that
JAX's ``param_sharding_rules`` split, as plain local tensors, and marks
each split block with its ``ModelAxis``. The rules, first match wins, on
the port's state-dict keys ("columns" are the output features: dim 0 of a
torch ``[out, in]`` weight, the columns of JAX's ``[in, out]`` w):

- encoder ``attn.qkv``, ``mlp.fc1`` and ``mlp.w12`` by columns, with
  their biases; ``attn.proj``, ``mlp.fc2`` and ``mlp.w3`` by rows (their
  biases whole: added once, after the sum over the model group);
- motion ``to_q``, ``to_k``, ``to_v`` and ``ff.net.0.proj`` by columns,
  ``to_out.0`` and ``ff.net.2`` by rows;
- int8 sites (``ops/quant.py``): ``w_i8`` as its float weight; the
  per-output-channel ``ws`` with a column-split weight's columns, whole
  for a row-split one; the activation absmaxes whole;
- everything else whole.

The fused projections are regrouped before they are cut: ``attn.qkv``
``[3D, D]`` gives each rank q, k and v of its own heads, ``w12`` ``[2H,
D]`` and ``ff.net.0.proj`` ``[8C, C]`` its part of x1 and of x2 (of val
and of gate); a contiguous cut would hand rank 0 all of q and part of k.
``gather_params`` undoes the regrouping.

As in JAX, a block whose dims do not divide the axis stays whole. The
port works on local heads, so for attention "divides" means the head
count divides: vits' 6 heads on a 4-wide axis leave that attention whole
(GSPMD would cut 96 columns, 1.5 heads), while its MLP is still split.
"""
from __future__ import annotations

import copy
import re

import torch
import torch.distributed as dist

from .tensor import ModelAxis


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ``DeviceMesh`` of shape (n_data, n_model) over every rank of the
    process group, on the group's device (``distributed.group_device_type``:
    what ``initialize`` chose). n_data defaults to world size // n_model."""
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import group_device_type

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n_data = max(world // n_model, 1) if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(group_device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def data_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("data"))


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def model_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


def model_rank(mesh) -> int:
    return mesh.get_local_rank("model")


def model_axis(mesh) -> ModelAxis | None:
    """This rank's model group as a ``ModelAxis``; None when the axis is 1."""
    if mesh is None or model_size(mesh) == 1:
        return None
    return ModelAxis(mesh.get_group("model"), model_size(mesh), model_rank(mesh))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: on a CUDA mesh the card that
    ``distributed.initialize`` made current, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def broadcast_(tensors, mesh) -> None:
    """Every tensor of ``tensors`` set, in place, to global rank 0's values
    over the whole mesh. A tensor off the mesh's device (AdamW's step
    counter on the CPU under NCCL) travels through a device copy."""
    device = mesh_device(mesh)
    for t in tensors:
        if t.device.type == device.type:
            dist.broadcast(t.data, src=0)
        else:
            buf = t.detach().to(device)
            dist.broadcast(buf, src=0)
            t.data.copy_(buf)


# ---------------------------------------------------------------- the rules

COLUMNS, ROWS = 0, 1     # the dim of a torch [out, in] weight that is cut

# (regex on the state-dict key, whose group "unit" is the block that is
# split or left whole as one; the dim cut; the fused groups regrouped
# before the cut), first match wins; every other key stays whole.
_RULES = [
    (r"^(?P<unit>pretrained\.blocks\.\d+\.attn)\.qkv\.(weight|bias|w_i8|ws)$", COLUMNS, 3),
    (r"^(?P<unit>pretrained\.blocks\.\d+\.attn)\.proj\.(weight|w_i8)$", ROWS, 1),
    (r"^(?P<unit>pretrained\.blocks\.\d+\.mlp)\.fc1\.(weight|bias|w_i8|ws)$", COLUMNS, 1),
    (r"^(?P<unit>pretrained\.blocks\.\d+\.mlp)\.fc2\.(weight|w_i8)$", ROWS, 1),
    (r"^(?P<unit>pretrained\.blocks\.\d+\.mlp)\.w12\.(weight|bias|w_i8|ws)$", COLUMNS, 2),
    (r"^(?P<unit>pretrained\.blocks\.\d+\.mlp)\.w3\.(weight|w_i8)$", ROWS, 1),
    (r"^(?P<unit>head\.motion_modules\..+\.attention_blocks\.\d+)\.to_[qkv]\."
     r"(weight|w_i8|ws)$", COLUMNS, 1),
    (r"^(?P<unit>head\.motion_modules\..+\.attention_blocks\.\d+)\.to_out\.0\.(weight|w_i8)$",
     ROWS, 1),
    (r"^(?P<unit>head\.motion_modules\..+\.ff)\.net\.0\.proj\.(weight|bias|w_i8|ws)$",
     COLUMNS, 2),
    (r"^(?P<unit>head\.motion_modules\..+\.ff)\.net\.2\.(weight|w_i8)$", ROWS, 1),
]


def param_sharding_rule(key: str):
    """(unit, dim, groups) of the first rule ``key`` matches, else None
    (the tensor stays whole)."""
    for pattern, dim, groups in _RULES:
        m = re.match(pattern, key)
        if m:
            return m.group("unit"), dim, groups
    return None


def shard_tensor(t: torch.Tensor, dim: int, groups: int, n: int, r: int) -> torch.Tensor:
    """Rank r's shard of ``t`` cut n ways on ``dim``: each of the ``groups``
    fused parts (q, k, v; x1, x2) cut on its own, the rank's pieces
    concatenated. A new tensor of its own."""
    v = t.unflatten(dim, (groups, n, t.shape[dim] // (groups * n)))
    return v.select(dim + 1, r).flatten(dim, dim + 1).clone()


def merge_shards(parts, dim: int, groups: int) -> torch.Tensor:
    """The inverse of ``shard_tensor`` over the ranks' shards, in rank order."""
    views = [p.unflatten(dim, (groups, p.shape[dim] // groups)) for p in parts]
    return torch.stack(views, dim + 1).flatten(dim, dim + 2)


def split_specs(model: torch.nn.Module) -> dict:
    """{state-dict key: (dim, groups)} of every tensor of ``model`` that is
    split (its block carries a ``ModelAxis``)."""
    out = {}
    for key in model.state_dict(keep_vars=True):
        rule = param_sharding_rule(key)
        if rule is not None and getattr(model.get_submodule(rule[0]), "tp", None) is not None:
            out[key] = rule[1:]
    return out


def _plan(model: torch.nn.Module, n: int) -> dict:
    """{unit: {key: (dim, groups)}} of the blocks that divide n ways."""
    sd = model.state_dict(keep_vars=True)
    units: dict = {}
    for key, t in sd.items():
        rule = param_sharding_rule(key)
        if rule is not None:
            units.setdefault(rule[0], {})[key] = (rule[1], rule[2], t.shape[rule[1]])
    plan = {}
    for unit, keys in units.items():
        block = model.get_submodule(unit)
        heads = getattr(block, "num_heads", None)
        ok = heads is None or heads % n == 0
        ok = ok and all(size % (groups * n) == 0 for _, groups, size in keys.values())
        rope = getattr(block, "rope", None)
        if ok and rope is not None:
            ok = rope.dim % (2 * n) == 0
        if ok:
            plan[unit] = {k: (dim, groups) for k, (dim, groups, _) in keys.items()}
    return plan


def _assign(model: torch.nn.Module, key: str, value: torch.Tensor) -> None:
    path, _, name = key.rpartition(".")
    mod = model.get_submodule(path)
    if name in mod._parameters:
        mod._parameters[name].data = value
    else:
        mod._buffers[name] = value


@torch.no_grad()
def split_params(model: torch.nn.Module, axis: ModelAxis | None) -> torch.nn.Module:
    """Keep, in place, ``axis.rank``'s shard of every tensor the rules split
    (no communication): each block that divides ``axis.size`` ways gets
    its shards, ``tp = axis`` and its local head count, and a RoPE table
    its channels' rows. Returns ``model``; a no-op when ``axis`` is None."""
    if axis is None:
        return model
    if any(getattr(m, "tp", None) is not None for m in model.modules()):
        raise ValueError("the model is already split over a model axis")
    sd = model.state_dict(keep_vars=True)
    n, r = axis.size, axis.rank
    for unit, keys in _plan(model, n).items():
        for key, (dim, groups) in keys.items():
            _assign(model, key, shard_tensor(sd[key].detach(), dim, groups, n, r))
        _place(model.get_submodule(unit), axis)
    return model


def _place(block: torch.nn.Module, axis: ModelAxis | None) -> None:
    """Set a block's model axis, head count and RoPE rows: ``axis``'s
    rank's share of them, or (None) the whole block's again."""
    n, r = (axis.size, axis.rank) if axis is not None else (1, 0)
    if hasattr(block, "num_heads"):
        block.num_heads = block.num_heads * (block.tp.size if block.tp is not None else 1) // n
    block.tp = axis
    rope = getattr(block, "rope", None)
    if rope is not None:
        half = rope.dim // (2 * n)
        rope.pairs = (r * half, (r + 1) * half)
        rope.freqs = rope._table(rope.freqs.device)


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Global rank 0's weights on every rank of ``mesh`` (every parameter and
    buffer broadcast, in place), then this rank's shard over the model
    axis (``split_params``). Returns ``model``."""
    broadcast_(model.state_dict(keep_vars=True).values(), mesh)
    return split_params(model, model_axis(mesh))


def gather_shard(t: torch.Tensor, dim: int, groups: int, axis: ModelAxis) -> torch.Tensor:
    """Every rank's shard of one tensor, merged back to the whole (one
    broadcast per rank of the model group, so each rank's bytes arrive as
    they are)."""
    parts = []
    for j in range(axis.size):
        buf = t.detach().contiguous() if j == axis.rank else torch.empty_like(t)
        dist.broadcast(buf, src=dist.get_global_rank(axis.group, j), group=axis.group)
        parts.append(buf)
    return merge_shards(parts, dim, groups)


@torch.no_grad()
def gather_params(model: torch.nn.Module, mesh) -> dict:
    """The whole state dict of a split ``model``, on every rank (a
    collective: every rank of the mesh calls it). Without a model axis, a
    copy of the state dict."""
    axis = model_axis(mesh)
    specs = split_specs(model) if axis is not None else {}
    out = {}
    for key, t in model.state_dict().items():
        out[key] = gather_shard(t, *specs[key], axis) if key in specs else t.clone()
    return out


@torch.no_grad()
def gather_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """A whole copy of a split ``model`` on every rank (a collective over
    the model group), the inverse of ``split_params``: every split tensor
    gathered, every block whole again. Without a model axis, a copy."""
    axis = model_axis(mesh)
    specs = split_specs(model) if axis is not None else {}
    whole = copy.deepcopy(model)
    sd = model.state_dict()
    for key, spec in specs.items():
        _assign(whole, key, gather_shard(sd[key], *spec, axis))
    for block in whole.modules():
        if getattr(block, "tp", None) is not None:
            _place(block, None)
    return whole


def shard_batch(batch, mesh):
    """This rank's rows of ``batch`` (a tensor or array, or a dict of them)
    on the data axis: contiguous, the batch a multiple of the axis; the
    ranks of one model group take the same rows."""
    from .distributed import process_batch_bounds

    def take(x):
        lo, hi = process_batch_bounds(x.shape[0], mesh)
        return x[lo:hi]

    return {k: take(v) for k, v in batch.items()} if isinstance(batch, dict) else take(batch)
