"""Checkpoint files: the JAX package's ``.npz`` layout and the default lookup.

The port's own copy of the JAX package's ``utils/params_io.py``. A
``.npz`` checkpoint holds the JAX parameter tree flattened to '/'-joined
keys (encoder blocks stacked on a leading depth axis); ``save_params``
writes one (``np.savez_compressed``, as JAX does), ``load_params`` reads it
with NumPy and unflattens it (``utils/tree.py``), and
``convert.state_dict_from_params`` turns the tree into a state_dict
(``convert.load_checkpoint`` does both for a ``.npz`` path).
``load_checkpoint`` gives the tree of a ``.npz`` or a ``.pth``.
``resolve_checkpoint`` is the reference layout's lookup, ``.npz`` before
``.pth``. ``save_model`` writes a model's weights, gathered whole first
when the model is split over a mesh's model axis.
"""
from __future__ import annotations

import os

import numpy as np

from .tree import flatten_tree, unflatten_tree


def save_params(path: str, params) -> None:
    """The nested parameter tree -> a flat-key ``.npz``."""
    np.savez_compressed(path, **flatten_tree(params))


def save_model(path: str, model, mesh=None) -> None:
    """A VideoDepthAnything's weights -> a flat-key ``.npz``. With ``mesh``
    the split tensors are gathered whole (``parallel.gather_params``, a
    collective: every rank of the mesh calls this) and global rank 0 alone
    writes."""
    import torch.distributed as dist

    from ..convert import params_from_state_dict
    from ..parallel import gather_params

    sd = model.state_dict() if mesh is None else gather_params(model, mesh)
    if mesh is None or dist.get_rank() == 0:
        save_params(path, params_from_state_dict(sd, model.cfg.vit.depth))


def load_params(path: str) -> dict:
    """A flat-key ``.npz`` -> the nested parameter tree of NumPy arrays."""
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def load_checkpoint(path: str, cfg) -> dict:
    """The parameter tree of a native ``.npz`` or a torch ``.pth`` / ``.pt``
    (converted by ``convert.load_torch_checkpoint``)."""
    if path.endswith((".pth", ".pt")):
        from ..convert import load_torch_checkpoint
        return load_torch_checkpoint(path, cfg.vit.depth)
    return load_params(path)


def resolve_checkpoint(encoder: str, metric: bool = False,
                       checkpoint_dir: str = "./checkpoints") -> str | None:
    """``<dir>/[metric_]video_depth_anything_<encoder>.npz``, else the same
    ``.pth``, else None."""
    prefix = "metric_video_depth_anything" if metric else "video_depth_anything"
    for ext in (".npz", ".pth"):
        p = os.path.join(checkpoint_dir, f"{prefix}_{encoder}{ext}")
        if os.path.exists(p):
            return p
    return None
