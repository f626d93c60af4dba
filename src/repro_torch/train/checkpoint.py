"""Checkpoints as msgpack-framed numpy arrays (counterpart of
``repro/train/checkpoint.py``), in the reference's layout:

    <dir>/manifest.msgpack   — leaf metadata (dtype, shape, offset) and an
                               informational description of the tree
    <dir>/data.bin           — raw little-endian leaf payloads, concatenated

so that a checkpoint written by either package restores in the other.
Leaves go in ``jax.tree.flatten`` order, which :func:`flatten` computes
without jax: NamedTuples and tuples in field order, lists in order, dicts in
sorted key order; ``None`` and ``()`` are empty nodes, not leaves.  Tensors
are written through ``.cpu().numpy()``, with numpy's dtype names (int32
seeds stay int32); a dtype numpy lacks (bfloat16) is refused, not
converted.  :func:`restore` returns numpy leaves, as the reference does: the
caller moves them to its device (the engine does, onto its own).  Saves
are atomic: written to ``<dir>.tmp``, then renamed.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from repro_torch.train import _msgpack

_TAG_ARRAY = "__array__"
_TAG_SCALAR = "__scalar__"


def _is_leaf(node) -> bool:
    return node is not None and not isinstance(node, (tuple, list, dict))


def flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if _is_empty(tree):
        return []
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    return [leaf for child in tree for leaf in flatten(child)]


def _is_empty(node) -> bool:
    return node is None or (isinstance(node, tuple) and not hasattr(node, "_fields")
                            and len(node) == 0)


def unflatten(template, leaves) -> object:
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves`` (as many as :func:`flatten` gives for it)."""
    it = iter(leaves)

    def build(node):
        if _is_empty(node):
            return node
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        items = [build(child) for child in node]
        if hasattr(node, "_fields"):
            return type(node)(*items)
        return type(node)(items)

    return build(template)


def map_leaves(fn, tree):
    """``fn`` on every leaf of ``tree``, keeping its structure."""
    return unflatten(tree, [fn(leaf) for leaf in flatten(tree)])


def describe(tree) -> str:
    """An informational text of ``tree``'s structure (the manifest's
    ``"treedef"``; never read back)."""
    if _is_empty(tree):
        return "None" if tree is None else "()"
    if _is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}" for k in sorted(tree)) + "}"
    inner = ", ".join(describe(child) for child in tree)
    if hasattr(tree, "_fields"):
        return f"{type(tree).__name__}({inner})"
    return f"[{inner}]" if isinstance(tree, list) else f"({inner})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "checkpoint leaves must have a numpy dtype; bfloat16 has none "
                "— cast the tensor (float32 holds every bfloat16 value) before "
                "saving"
            )
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_serializable(tree):
    """Manifest entries for ``tree``'s leaves, and the array payloads."""
    payloads: list[np.ndarray] = []

    def visit(arr: np.ndarray):
        if arr.ndim == 0:
            return {_TAG_SCALAR: arr.item(), "dtype": str(arr.dtype)}
        payloads.append(np.ascontiguousarray(arr))
        return {
            _TAG_ARRAY: len(payloads) - 1,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }

    manifest_leaves = [visit(_to_numpy(leaf)) for leaf in flatten(tree)]
    return manifest_leaves, payloads


def save(path: str, tree, step: int | None = None) -> str:
    """Save ``tree`` under ``path`` (optionally path/step_<N>). Returns dir."""
    out_dir = os.path.join(path, f"step_{step}") if step is not None else path
    tmp_dir = out_dir + ".tmp"
    manifest_leaves, payloads = _to_serializable(tree)
    os.makedirs(tmp_dir, exist_ok=True)

    offsets, off = [], 0
    for p in payloads:
        offsets.append(off)
        off += p.nbytes

    manifest = {
        "treedef": describe(tree),  # informational; reconstruction uses template
        "leaves": manifest_leaves,
        "offsets": offsets,
        "total_bytes": off,
    }
    with open(os.path.join(tmp_dir, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(manifest))
    with open(os.path.join(tmp_dir, "data.bin"), "wb") as f:
        for p in payloads:
            f.write(p.tobytes())

    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.rename(tmp_dir, out_dir)
    return out_dir


def restore(path: str, template):
    """Restore into the structure of ``template`` (numpy leaves; shapes come
    from the manifest)."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    data = os.path.join(path, "data.bin")
    # np.memmap cannot map an empty file (a tree of scalars or empty nodes)
    blob = (np.memmap(data, dtype=np.uint8, mode="r") if os.path.getsize(data)
            else np.zeros(0, np.uint8))

    leaves_meta = manifest["leaves"]
    offsets = manifest["offsets"]

    def materialize(meta):
        if _TAG_SCALAR in meta:
            return np.dtype(meta["dtype"]).type(meta[_TAG_SCALAR])
        idx = meta[_TAG_ARRAY]
        dtype = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        start = offsets[idx]
        return (
            np.frombuffer(bytes(blob[start : start + nbytes]), dtype=dtype)
            .reshape(shape)
            .copy()
        )

    restored = [materialize(m) for m in leaves_meta]
    num_leaves = len(flatten(template))
    if num_leaves != len(restored):
        raise ValueError(
            f"checkpoint has {len(restored)} leaves, template expects "
            f"{num_leaves}"
        )
    return unflatten(template, restored)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(path)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None
