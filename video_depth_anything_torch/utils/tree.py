"""Nested dicts <-> flat '/'-joined keys, for ``.npz`` side files.

The port's own copy of the JAX package's ``utils/params_io.py``
``flatten_tree`` / ``unflatten_tree``, so a file written by either package
reads in the other.
"""
from __future__ import annotations

import numpy as np


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
