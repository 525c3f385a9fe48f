"""Minimal dependency-free checkpointing: trees of tensors <-> an .npz and
a JSON description (the reference's ``train/checkpoint.py`` layout).

Leaves are flattened in the reference's order (dict keys sorted, lists in
order) and stored as ``a0, a1, ...``; bf16, which npz cannot store, is
kept as its uint16 bits with a dtype tag.  Tensors are copied to the host
for the save and placed on the device of the matching leaf of ``like`` on
load.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .optimizer import tree_leaves


def _treedef(tree) -> str:
    """The tree's structure as text (``*`` for a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, []
    for i, x in enumerate(tree_leaves(tree)):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                # npz has no bf16: store its bits with a dtype tag
                arrays[f"a{i}"] = x.view(torch.int16).numpy().view(np.uint16)
                dtypes.append("bfloat16")
                continue
            x = x.numpy()
        a = np.asarray(x)
        arrays[f"a{i}"] = a
        dtypes.append(str(a.dtype))
    np.savez(path + ".npz", **arrays)
    with open(path + ".tree.json", "w") as f:
        json.dump({"treedef": _treedef(tree), "n": len(dtypes),
                   "dtypes": dtypes}, f)


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape-checked): tensors on
    the device of ``like``'s leaf, other leaves as numpy arrays."""
    data = np.load(path + ".npz")
    with open(path + ".tree.json") as f:
        meta = json.load(f)
    leaves_like = tree_leaves(like)
    assert meta["n"] == len(leaves_like), "checkpoint/model structure mismatch"
    out = []
    for i, ref in enumerate(leaves_like):
        a = data[f"a{i}"]
        if meta["dtypes"][i] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        assert tuple(t.shape) == shape, (i, tuple(t.shape), shape)
        out.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else a)
    return _unflatten(like, out)


def exists(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".tree.json")
