"""Minimal tree checkpointing (numpy .npz + structure manifest), in the
on-disk format of ``repro/training/checkpoint.py``: ``arrays.npz`` holds
leaf ``i`` as ``leaf_{i}`` (bfloat16 stored as float32: numpy has no
bfloat16), and ``manifest.json`` holds ``num_leaves``, ``step``, the
leaves' ``dtypes`` and a ``treedef`` string.

Leaf ``i`` is the reference's leaf ``i``: trees are flattened as
``jax.tree.flatten`` flattens them, dict keys in sorted order and lists
in order (the port's dicts iterate in insertion order, which differs).
A checkpoint written by either package therefore loads into the other.
``treedef`` is the port's own structure string (JAX's cannot be written
without JAX); neither package reads it back.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree):
    """(leaves in JAX's order, structure string)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                "{" + ", ".join(f"{k!r}: {p[1]}"
                                for k, p in zip(keys, parts)) + "}")
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                "[" + ", ".join(p[1] for p in parts) + "]")
    return [tree], "*"


def _unflatten(like, leaves):
    """``leaves`` (in ``_flatten`` order) in the structure of ``like``,
    whose own key order is kept."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            new = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [rebuild(v) for v in node]
        return next(it)
    return rebuild(like)


def _numpy(t):
    t = torch.as_tensor(t).detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def save_checkpoint(path: str, tree, step: int | None = None):
    os.makedirs(path, exist_ok=True)
    leaves, treedef = _flatten(tree)
    arrs, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        dtypes.append(str(torch.as_tensor(leaf).dtype).removeprefix("torch."))
        arrs[f"leaf_{i}"] = _numpy(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **arrs)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"treedef": treedef, "num_leaves": len(leaves),
                   "step": step, "dtypes": dtypes}, f)


def load_checkpoint(path: str, like_tree):
    """The checkpoint's leaves in the structure of ``like_tree``, each in
    its ``like_tree`` leaf's dtype and on its device."""
    leaves, _ = _flatten(like_tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"tree structure mismatch: the checkpoint has "
                         f"{manifest['num_leaves']} leaves, the tree "
                         f"{len(leaves)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        new = [torch.from_numpy(data[f"leaf_{i}"]).to(
            dtype=leaf.dtype, device=leaf.device)
            for i, leaf in enumerate(leaves)]
    return _unflatten(like_tree, new)
