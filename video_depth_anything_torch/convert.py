"""Carry weights across: the JAX package's parameter tree <-> this port's
``state_dict``.

The port's own copy of the logic of the JAX package's
``utils/torch_convert.py::export_torch_state_dict``. The input is the JAX
tree as nested dicts of NumPy arrays (encoder blocks stacked on a leading
depth axis, as ``init_params`` and ``.npz`` checkpoints hold them); the
output is keyed like the original checkpoints, which the port's modules
mirror, so ``VideoDepthAnything.load_state_dict(..., strict=True)`` takes
it:

  - stacked ``blocks`` leaves       -> ``blocks.{i}.*``
  - encoder q / k / v projections   -> one fused ``attn.qkv`` ([3D, D], [3D])
  - linear ``w`` [in, out]          -> ``weight`` [out, in]
  - conv ``w`` HWIO                 -> OIHW (``resize_layers.{0,1}``: HWOI -> IOHW,
                                       the same permutation)
  - norm ``scale`` / ``bias``       -> ``weight`` / ``bias``
  - BatchNorm ``mean`` / ``var``    -> ``running_mean`` / ``running_var``,
                                       and a zero ``num_batches_tracked``
  - the RoPE table ``_freqs_cis``   -> dropped (a buffer the port builds)

``params_from_state_dict`` is the inverse (the port's copy of
``convert_torch_state_dict``), bit for bit: a state dict (a reference
``.pth`` or the port's) -> the tree of float32 NumPy arrays, which
``utils/params_io.py::save_params`` writes as the native ``.npz``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _emit(sd: dict, key: str, leaf: str, v: np.ndarray) -> None:
    base = key[: -len(leaf)]
    if leaf == "w":
        sd[base + "weight"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    elif leaf == "b":
        sd[base + "bias"] = v
    elif leaf == "scale":
        sd[base + "weight"] = v
    elif leaf == "mean":   # BatchNorm running statistics (use_bn heads)
        sd[base + "running_mean"] = v
        sd[base + "num_batches_tracked"] = np.zeros((), np.int64)
    elif leaf == "var":
        sd[base + "running_var"] = v
    else:  # norm bias, LayerScale gamma, APE pe, cls_token, pos_embed, ...
        sd[key] = v


def _walk(sd: dict, node: Mapping, prefix: str) -> None:
    for k, v in node.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if k in ("qs", "w_i8", "ws"):
            raise ValueError(f"cannot convert int8-quantized leaf {key}")
        if k == "_freqs_cis":   # the RoPE table: no checkpoint tensor; the port builds it
            continue
        if isinstance(v, Mapping):
            _walk(sd, v, key)
        else:
            _emit(sd, key, str(k), np.asarray(v, dtype=np.float32))


def _numpy(node: Mapping) -> dict:
    return {k: _numpy(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in node.items()}


def _block(blocks: Mapping, i: int) -> dict:
    return {k: _block(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in blocks.items()}


def state_dict_from_params(params: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> port state_dict.

    ``depth`` is the encoder's block count (``cfg.vit.depth``).
    """
    sd: Dict[str, np.ndarray] = {}
    for top, sub in params.items():
        if top != "pretrained":
            _walk(sd, {top: sub}, "")
            continue
        for k, v in sub.items():
            if k != "blocks":
                _walk(sd, {k: v}, "pretrained")
                continue
            v = _numpy(v)   # one host copy of each stacked leaf
            for i in range(depth):
                blk = _block(v, i)
                attn = blk["attn"]
                pre = f"pretrained.blocks.{i}.attn.qkv."
                sd[pre + "weight"] = np.concatenate(
                    [attn[n]["w"].T for n in "qkv"], axis=0).astype(np.float32)
                if "b" in attn["q"]:
                    sd[pre + "bias"] = np.concatenate(
                        [attn[n]["b"] for n in "qkv"]).astype(np.float32)
                blk["attn"] = {n: p for n, p in attn.items() if n not in ("q", "k", "v")}
                _walk(sd, blk, f"pretrained.blocks.{i}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _set(tree: dict, path: list, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _is_norm(parts: list) -> bool:
    """LayerNorm / GroupNorm / BatchNorm leaves are ``scale`` / ``bias``."""
    if parts[-2] in ("norm", "norm1", "norm2", "ff_norm", "bn1", "bn2"):
        return True
    return len(parts) >= 3 and parts[-3] == "norms"


def _stack(blocks: list) -> dict:
    return {k: _stack([b[k] for b in blocks]) if isinstance(blocks[0][k], dict)
            else np.stack([b[k] for b in blocks]) for k in blocks[0]}


def _float32(tree: dict) -> dict:
    return {k: _float32(v) if isinstance(v, dict) else np.asarray(v, dtype=np.float32)
            for k, v in tree.items()}


def params_from_state_dict(state_dict: Mapping, depth: int) -> dict:
    """A state dict (tensors or arrays; ``pretrained.*`` with a fused
    ``attn.qkv``, and ``head.*``) -> the JAX package's parameter tree,
    nested dicts of float32 NumPy arrays, encoder blocks stacked on a
    leading ``depth`` axis. ``num_batches_tracked`` is dropped (the tree
    has no counter; ``state_dict_from_params`` regenerates it as 0)."""
    tree: dict = {}
    for key, val in state_dict.items():
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        parts = key.split(".")
        leaf = parts[-1]
        if key.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            for name, x in zip("qkv", np.split(v, 3, axis=0)):
                _set(tree, parts[:-2] + [name, "w" if leaf == "weight" else "b"],
                     x.T if leaf == "weight" else x)
        elif leaf == "weight":
            if v.ndim == 4:   # OIHW -> HWIO; resize_layers.{0,1}: IOHW -> HWOI, the same
                _set(tree, parts[:-1] + ["w"], v.transpose(2, 3, 1, 0))
            elif v.ndim == 2:
                _set(tree, parts[:-1] + ["w"], v.T)
            elif v.ndim == 1:
                _set(tree, parts[:-1] + ["scale"], v)
            else:
                raise ValueError(f"unexpected weight ndim for {key}: {v.shape}")
        elif leaf == "bias":
            _set(tree, parts[:-1] + ["bias" if v.ndim == 1 and _is_norm(parts) else "b"], v)
        elif leaf in ("gamma", "pe"):
            _set(tree, parts, v)
        elif leaf == "running_mean":
            _set(tree, parts[:-1] + ["mean"], v)
        elif leaf == "running_var":
            _set(tree, parts[:-1] + ["var"], v)
        elif leaf == "num_batches_tracked":
            continue
        elif leaf in ("cls_token", "pos_embed", "mask_token", "register_tokens"):
            _set(tree, parts, v)
        else:
            raise ValueError(f"unmapped checkpoint key: {key}")
    blocks = tree["pretrained"]["blocks"]
    tree["pretrained"]["blocks"] = _stack([blocks[str(i)] for i in range(depth)])
    return _float32(tree)


def load_torch_checkpoint(path: str, depth: int) -> dict:
    """A ``.pth`` state dict (or one under ``"model"``) -> the parameter
    tree (``params_from_state_dict``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return params_from_state_dict(sd, depth)


def model_from_params(params: Mapping, cfg) -> torch.nn.Module:
    """A VideoDepthAnything (eval mode, CPU) holding the JAX tree's weights,
    loaded with strict=True."""
    from .models import build_model

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_params(params, cfg.vit.depth), strict=True)
    return model


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a checkpoint into ``model`` with strict=True: a reference
    ``.pth`` state_dict, or the JAX package's ``.npz`` (its parameter tree
    flattened to '/'-joined keys, ``utils/params_io.py``)."""
    if path.endswith(".npz"):
        from .utils.params_io import load_params
        sd = state_dict_from_params(load_params(path), model.cfg.vit.depth)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
    model.load_state_dict(sd, strict=True)
    return model
