"""Sharding hints and the model code's collectives (counterpart of
``repro/models/hints.py``).

The reference's models stay mesh-agnostic and pin layouts with
``with_sharding_constraint`` under ``jax.set_mesh``; XLA then inserts the
collectives.  The port is explicit SPMD: one process per rank, each holding
its slice of every parameter (``launch/shardings.py``), and the model code
calls the collectives below where the reference's XLA inserts them.

* :func:`use_mesh` makes a mesh active for the code inside it (the
  counterpart of ``compat.set_mesh``); :func:`active_mesh` reads it, and is
  ``None`` outside, where every model runs on one device as before.
* :func:`axis_extent` and :func:`pick_divisible` follow the reference.
* :func:`hint` returns ``x`` itself with no mesh.  Under a mesh it gives
  this rank's slice of ``x`` (a tensor every rank holds whole) along each
  named dim that divides, as the reference's constraint shards it.

The differentiable collectives, each a ``torch.autograd.Function`` over
``Mesh.gather_axis`` (sums are a gather and a sum in rank order, so every
rank gets the same bits).  Gradients follow one rule: a tensor every rank
holds whole carries on each rank the gradient of the work that rank did
with it, and the gradient of the whole program is the sum over the ranks,
taken where the ranks' work parted:

* :func:`psum`: forward the sum over ``axes``; backward the identity (the
  sum feeds work every rank does alike).
* :func:`copy`: forward the identity; backward the sum over ``axes`` (the
  input feeds work that differs by rank: column-parallel products, a
  rank's heads or stripe).
* :func:`all_gather`: forward the parts of every rank along ``dim``;
  backward the sum over ``axes``, then this rank's part.  The sum is
  needed because the ranks do different work with the whole: a plain slice
  would be right only where every rank then does the same.
* :func:`take_shard`: forward this rank's part along ``dim``; backward the
  parts of every rank gathered along ``dim`` (the input is held whole and
  each rank's part of its gradient lives on that rank).
* :func:`replicate`: forward the parts of every rank along ``dim``, as
  :func:`all_gather`; backward this rank's part of the gradient, no sum
  (the whole feeds work every rank does alike: the residual stream after
  a column-parallel projection, a weight every rank then uses whole).
  It is :func:`take_shard` the other way round.

With no process group, or an axis of one rank, each is the identity.

:func:`remat` is ``torch.utils.checkpoint`` of a layer with this thread's
active mesh carried into the recomputation, which the backward runs on
the autograd engine's thread (a CUDA device's worker thread on the card).

:func:`gather_data` gathers the leaves of a parameter tree that FSDP splits
over the data axes (each leaf's spec says which), with
:func:`all_gather`: the models call it on a layer inside its
rematerialised body, so the gathered copy is freed after the layer.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import data_axes, gather_parts, part
from repro_torch.launch.shardings import entry_axes

Axis = str | tuple[str, ...]

# a stack of active meshes per thread, so threads can stand for ranks
_LOCAL = threading.local()


def _stack() -> list:
    if not hasattr(_LOCAL, "meshes"):
        _LOCAL.meshes = []
    return _LOCAL.meshes


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block (``None``: none), in
    this thread."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh():
    """The mesh of this thread's innermost :func:`use_mesh`, or ``None``."""
    meshes = _stack()
    mesh = meshes[-1] if meshes else None
    if mesh is None or not tuple(getattr(mesh, "axis_names", ())):
        return None
    return mesh


def axis_extent(mesh, axis: Axis) -> int:
    names = (axis,) if isinstance(axis, str) else axis
    sizes = dict(mesh.shape)
    return math.prod(sizes.get(n, 0) or 0 for n in names) or 0


def pick_divisible(mesh, axis: str, *candidates: tuple[int, int]) -> int | None:
    """First candidate (dim_index, dim_size) divisible by the axis extent."""
    ext = axis_extent(mesh, axis)
    if not ext:
        return None
    for idx, size in candidates:
        if size % ext == 0:
            return idx
    return None


def _axes(mesh, axes: Axis) -> tuple[str, ...]:
    """``axes`` in mesh order, those of the mesh only."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in names)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return gather_parts(mesh, x.contiguous(), dim, axes)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.psum(g.contiguous(), ctx.axes)
        return part(ctx.mesh, total, ctx.dim, ctx.axes).contiguous(), None, None, None


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return part(mesh, x, dim, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_parts(ctx.mesh, g.contiguous(), ctx.dim, ctx.axes), None, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return gather_parts(mesh, x.contiguous(), dim, axes)

    @staticmethod
    def backward(ctx, g):
        return part(ctx.mesh, g, ctx.dim, ctx.axes).contiguous(), None, None, None


def psum(x: torch.Tensor, mesh, axes: Axis = "model") -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``; backward: the identity."""
    axes = _axes(mesh, axes)
    return _Psum.apply(x, mesh, axes) if axes else x


def copy(x: torch.Tensor, mesh, axes: Axis = "model") -> torch.Tensor:
    """``x`` itself; backward: the sum of every rank's gradient over ``axes``."""
    axes = _axes(mesh, axes)
    return _Copy.apply(x, mesh, axes) if axes else x


def all_gather(x: torch.Tensor, mesh, dim: int, axes: Axis = "model") -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` (the
    first axis outermost); backward: the sum over ``axes``, then this
    rank's part."""
    axes = _axes(mesh, axes)
    return _AllGather.apply(x, mesh, dim % x.ndim, axes) if axes else x


def take_shard(x: torch.Tensor, mesh, dim: int, axes: Axis = "model") -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` over ``axes``; backward: the
    parts of every rank's gradient gathered along ``dim``."""
    axes = _axes(mesh, axes)
    return _TakeShard.apply(x, mesh, dim % x.ndim, axes) if axes else x


def replicate(x: torch.Tensor, mesh, dim: int, axes: Axis = "model") -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim``, for work
    every rank then does alike; backward: this rank's part of the gradient."""
    axes = _axes(mesh, axes)
    return _Replicate.apply(x, mesh, dim % x.ndim, axes) if axes else x


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, no RNG
    state: the layers draw no random numbers), the active mesh entered
    again when the backward recomputes it."""
    mesh = active_mesh()

    def run(*a):
        with use_mesh(mesh):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def gather_data(tree, specs, mesh, dims: slice, shift: int = 0):
    """``tree`` (dicts and lists of tensors) with each leaf gathered over the
    data axes its spec in ``specs`` names at the spec entries ``dims``
    (``shift``: the spec's entries before the leaf's own dims, 1 for a
    layer view of a stacked leaf).  ``mesh=None``: ``tree`` itself."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_data(v, specs[k], mesh, dims, shift) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_data(v, s, mesh, dims, shift) for v, s in zip(tree, specs, strict=True)]
    dp = data_axes(mesh)
    for i in range(len(specs))[dims]:
        axes = tuple(a for a in entry_axes(specs[i]) if a in dp)
        if axes:
            tree = all_gather(tree, mesh, i - shift, axes)
    return tree


def hint(x: torch.Tensor, dims: dict[int, Axis]) -> torch.Tensor:
    """This rank's slice of ``x`` with dim ``d`` sharded over ``dims[d]``
    where the dim divides by the axes' extent (the reference's rule); ``x``
    itself with no active mesh or nothing to shard."""
    mesh = active_mesh()
    if mesh is None:
        return x
    used: set = set()
    for d, axis in dims.items():
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        names = tuple(n for n in names if n in mesh.axis_names and n not in used)
        if not names:
            continue
        ext = axis_extent(mesh, names)
        if ext and x.shape[d] % ext == 0:
            x = take_shard(x, mesh, d, names)
            used.update(names)
    return x


def model_rank(mesh) -> tuple[int, int]:
    """(this rank's index along ``model``, the model extent); (0, 1) for a
    mesh without a model axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return 0, 1
    return mesh.coordinate("model"), mesh.shape["model"]
