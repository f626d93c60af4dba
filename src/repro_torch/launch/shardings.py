"""Sharding rules: params / optimizer state / inputs / decode caches
(counterpart of ``repro/launch/shardings.py``).

Megatron-style 2D layout on axes (data, model), plus a leading 'pod' axis
that extends data parallelism across pods, decided by parameter name:

  * column-parallel weights (head/ffn/latent-up projections) shard their
    output feature dim over ``model``;
  * row-parallel weights (wo / w_down / out_proj) shard their input dim,
    so the block's output is one sum over ``model``;
  * expert weights shard the expert axis over ``model`` (expert parallelism);
  * embedding/LM-head shard the vocab dim over ``model``;
  * everything stacked has a leading layer axis which stays unsharded;
  * an axis is only used when the dim is divisible by its size;
  * leaves of at least ``FSDP_MIN_ELEMENTS`` elements also shard their
    biggest unsharded dim over ``data`` (ZeRO/FSDP-style).

A spec is a tuple with one entry per dim of the leaf (an axis name, a tuple
of axis names, or ``None``), or ``()`` for a replicated leaf: entry for
entry the reference's ``PartitionSpec``.  The rules are pure functions of
names, shapes and a mesh's ``axis_names`` and ``shape``, so they take the
port's :class:`~repro_torch.launch.mesh.Mesh` as well as any object with
those two attributes.  Where the reference returns a ``NamedSharding``, the
functions here return the spec: the port has no sharded array type.

What XLA did implicitly is explicit here: :func:`shard_tree` takes this
rank's slice of each full leaf and :func:`gather_tree` rebuilds the full
leaves from every rank's slice.  Each rank holds its slice of every leaf,
and the model code (``models/hints.py``) calls the collectives.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import data_axes, gather_parts, part

# output-feature-dim sharded (last dim)
_COL_PAR = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_uq", "w_uk", "w_uv",
    "w_x", "w1", "w2", "lm_head", "w_q",
}
# input-feature-dim sharded (second-to-last dim)
_ROW_PAR = {"wo", "w_down", "w_out", "out_proj", "w_r", "w_i"}
# 1-d params tied to a column-parallel output dim
_COL_PAR_VEC = {"bq", "bk", "bv", "b_up"}

# Leaves larger than this get their biggest unsharded dim sharded over
# ``data`` as well (ZeRO/FSDP-style): parameters, gradients and Adam moments
# all inherit it.  Read at each call, so a caller may lower it.
FSDP_MIN_ELEMENTS = 1 << 24

Spec = tuple


def _mesh_axis_size(mesh, axis: str) -> int:
    return dict(mesh.shape)[axis]


def _axis_ok(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and dim % _mesh_axis_size(mesh, axis) == 0


def _with_fsdp(spec: list, shape, mesh) -> Spec:
    if math.prod(shape) >= FSDP_MIN_ELEMENTS and "data" in mesh.axis_names:
        candidates = sorted((i for i in range(len(shape)) if spec[i] is None),
                            key=lambda i: -shape[i])
        for i in candidates:
            if _axis_ok(shape[i], mesh, "data"):
                spec[i] = "data"
                break
    return tuple(spec)


def param_spec(path, leaf, mesh) -> Spec:
    """The spec of the parameter at ``path`` (its keys, outermost first;
    only the string keys count) with ``leaf.shape``."""
    names = [n for n in path if isinstance(n, str)]
    last = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)

    def spec_tail(tail: list) -> list:
        return [None] * (nd - len(tail)) + tail

    if "experts" in names:
        # [L, E, d, f]: expert-parallel over model; tensor-parallel within
        # the expert FFN when the expert count does not divide.
        spec = [None] * nd
        e_dim = nd - 3
        if _axis_ok(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"
        elif last in ("w_gate", "w_up") and _axis_ok(shape[-1], mesh, "model"):
            spec[-1] = "model"
        elif last == "w_down" and _axis_ok(shape[-2], mesh, "model"):
            spec[-2] = "model"
        return _with_fsdp(spec, shape, mesh)
    if last == "table":
        # vocab over model only
        spec = [None] * nd
        if _axis_ok(shape[0], mesh, "model"):
            spec[0] = "model"
        return tuple(spec)
    if last == "dec_pos":
        return ()
    if last in _COL_PAR and nd >= 2:
        spec = spec_tail([None, "model" if _axis_ok(shape[-1], mesh, "model") else None])
        return _with_fsdp(spec, shape, mesh)
    if last in _ROW_PAR and nd >= 2:
        spec = spec_tail(["model" if _axis_ok(shape[-2], mesh, "model") else None, None])
        return _with_fsdp(spec, shape, mesh)
    if last in _COL_PAR_VEC and nd >= 1:
        return tuple(spec_tail(["model"])) if _axis_ok(shape[-1], mesh, "model") else ()
    # Un-named big weights (mamba in_proj, projector, conv) still get FSDP.
    if nd >= 2:
        return _with_fsdp([None] * nd, shape, mesh)
    return ()


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples, keeping its structure (``path``: dict keys, NamedTuple
    field names and sequence indices, outermost first)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree, strict=True)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_shardings(params_shape: Any, mesh):
    """The spec of every parameter leaf, in the tree's structure."""
    return map_with_path(lambda path, leaf: param_spec(path, leaf, mesh), params_shape)


def opt_state_shardings(opt_state_shape: Any, params_shardings: Any, mesh):
    """Adam moments mirror parameter shardings; scalars replicate."""
    from repro_torch.optim.adam import AdamState

    del mesh
    if isinstance(opt_state_shape, AdamState):
        return AdamState(step=(), mu=params_shardings, nu=params_shardings)
    # Fallback: replicate anything unknown.
    return map_with_path(lambda path, leaf: (), opt_state_shape)


def _dp_entry(dp: tuple[str, ...]):
    return dp if len(dp) > 1 else dp[0]


def batch_shardings(batch_specs: dict, mesh):
    """Inputs: batch dim over (pod, data); everything else replicated."""
    dp = data_axes(mesh)
    total = math.prod(_mesh_axis_size(mesh, a) for a in dp)

    def spec(path, leaf):
        nd = len(leaf.shape)
        parts: list = [None] * nd
        if nd and dp and leaf.shape[0] % total == 0:
            parts[0] = _dp_entry(dp)
        return tuple(parts)

    return map_with_path(spec, batch_specs)


def cache_shardings(cache_specs: Any, cfg: ArchConfig, mesh):
    """Decode caches: batch over (pod, data); heads over model when
    divisible, otherwise the sequence dim over model (flash-decoding
    style)."""
    del cfg
    dp = data_axes(mesh)
    dp_total = math.prod(_mesh_axis_size(mesh, a) for a in dp)

    def spec(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts: list = [None] * nd
        if nd >= 2:
            # the leading dim is the stacked layer/period axis; batch is
            # dim 1 for caches, dim 0 for unstacked ones
            b_dim = 1 if nd >= 3 else 0
            if dp and shape[b_dim] % dp_total == 0:
                parts[b_dim] = _dp_entry(dp)
        if nd >= 4:
            # [L, B, S, H(, hd)]: prefer heads over model, else sequence
            h_dim, s_dim = 3, 2
            if nd >= 5 and _axis_ok(shape[h_dim], mesh, "model"):
                parts[h_dim] = "model"
            elif _axis_ok(shape[s_dim], mesh, "model"):
                parts[s_dim] = "model"
        elif nd == 3 and shape[-1] % _mesh_axis_size(mesh, "model") == 0:
            # e.g. RecState.lru [Pd, B, W]: width over model
            parts[-1] = "model"
        return tuple(parts)

    return map_with_path(spec, cache_specs)


# ---------------------------------------------------------------------------
# Slices of full leaves, and full leaves from slices
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (``None``: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every axis a leaf of ``spec`` is sharded over."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def local_view(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the full leaf ``t`` under ``spec``, as a view:
    along each sharded dim, ``mesh.part`` over its axes (flattened in mesh
    order, the first outermost)."""
    for dim, entry in enumerate(spec):
        if entry_axes(entry):
            t = part(mesh, t, dim, entry_axes(entry))
    return t


def shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the full leaf ``t`` under ``spec``, a copy, so
    the full leaf can be freed."""
    return local_view(t, spec, mesh).clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice ``t`` under ``spec``: per
    sharded dim, ``mesh.gather_parts`` over its axes."""
    for dim, entry in enumerate(spec):
        if entry_axes(entry):
            t = gather_parts(mesh, t, dim, entry_axes(entry))
    return t


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, specs, strict=True)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs, strict=True))
    if tree is None:
        return None
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """This rank's slice of every full leaf of ``tree`` (``specs`` in its
    structure, as :func:`param_shardings` gives them)."""
    return _zip_map(lambda t, s: shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """Every full leaf of ``tree`` from every rank's slices (the inverse of
    :func:`shard_tree`; every rank gets them all)."""
    return _zip_map(lambda t, s: gather(t, s, mesh), tree, specs)


@functools.lru_cache(maxsize=16)
def _lm_param_specs(cfg: ArchConfig, axis_names: tuple, shape: tuple, fsdp_min: int):
    """Cached by everything the rules read (``fsdp_min``: the threshold at
    the call)."""
    from repro_torch.models.api import get_bundle

    mesh = types.SimpleNamespace(axis_names=axis_names,
                                 shape=dict(zip(axis_names, shape, strict=True)))
    return param_shardings(get_bundle(cfg).init(0, device="meta"), mesh)


def lm_param_specs(cfg: ArchConfig, mesh):
    """The specs of ``cfg``'s LM parameters on ``mesh``, from their full
    shapes (``bundle.init`` on the meta device): what every rank's train
    step and sharded forward read."""
    return _lm_param_specs(cfg, tuple(mesh.axis_names),
                           tuple(dict(mesh.shape)[a] for a in mesh.axis_names),
                           FSDP_MIN_ELEMENTS)
