"""Checkpoints of optimization state (mitsuba_tpu/utils/checkpoint.py).

The renderer is stateless (a render is a function of the seed); what an
optimization carries is its parameters and the optimizer's state.  Here
any tree of dicts, lists and tuples over tensors, arrays and numbers is
saved to one ``.npz`` (no pickles), keyed by its paths, and restored into
the structure, dtypes and devices of a tree like it.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """[(path, leaf)] in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in
                _flatten(x, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree) -> str:
    """Write ``tree`` to ``path`` (".npz" appended if missing), atomically:
    a killed writer leaves the previous checkpoint.  Returns the file."""
    out = _npz(path)
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in _flatten(tree)}
    tmp = out + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, out)
    return out


def load_checkpoint(path: str, like):
    """The tree saved at ``path``, in the structure of ``like``: a tensor
    leaf comes back a tensor of its dtype on its device, a Python number
    the same type, anything else an array.  Raises FileNotFoundError
    without a checkpoint and KeyError when ``like`` has a path the file
    lacks."""
    with np.load(_npz(path), allow_pickle=False) as data:
        saved = {k: data[k] for k in data.files}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(x, f"{prefix}/{i}")
                              for i, x in enumerate(tree))
        a = saved[prefix]
        if isinstance(tree, torch.Tensor):
            return torch.as_tensor(a, dtype=tree.dtype, device=tree.device)
        if isinstance(tree, (bool, int, float)):
            return type(tree)(a)
        return a

    return rebuild(like)
