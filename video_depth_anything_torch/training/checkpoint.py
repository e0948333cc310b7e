"""Training checkpoint and resume (the port of the JAX package's
``training/checkpoint.py``): the best_checkpoint / latest_checkpoint
scheme, model + optimizer + counters, through ``torch.save`` and
``torch.load(weights_only=True)`` instead of orbax."""
from __future__ import annotations

import os

import torch


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name)


def save_checkpoint(directory: str, name: str, state, extra: dict, write: bool = True) -> str:
    """Save a TrainState (step, every model tensor, AdamW's state) and the
    counters ``extra`` (epoch / best_val_loss / trial) -> the path. On a
    model axis the state's tensors are gathered whole (``state_dict()``,
    a collective): every rank calls this, and only the one given
    ``write=True`` writes."""
    path = _path(directory, name)
    sd = state.state_dict()
    if write:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save({**sd, "extra": dict(extra)}, tmp)
        os.replace(tmp, path)
    return path


def load_checkpoint(directory: str, name: str, template=None):
    """-> {"step", "params", "opt_state", "extra"}, or None if absent. With
    ``template`` (a TrainState) the state is also restored into it."""
    path = _path(directory, name)
    if not os.path.exists(path):
        return None
    restored = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        template.load_state_dict(restored)
    return restored


def latest_exists(directory: str) -> bool:
    return os.path.exists(_path(directory, "latest_checkpoint"))
