"""Optimiser base types and update helpers (counterpart of
``repro/optim/base.py``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


class Optimizer(NamedTuple):
    """A gradient transformation: init(params) -> state; update -> (updates, state)."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype, added in place; returns
    ``params``."""
    for p, u in zip(pytree.tree_leaves(params), pytree.tree_leaves(updates), strict=True):
        p.add_(u)
    return params


def global_norm(tree, *, axes=None, mesh=None) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in float32.  On a mesh, ``axes`` gives
    for each leaf (in ``tree_leaves`` order) the mesh axes its slices split
    it over: each leaf's local sum of squares is summed over exactly those,
    so a leaf every rank holds whole counts once, and every rank gets the
    one-device norm."""
    leaves = pytree.tree_leaves(tree)
    sums = [torch.sum(torch.square(x.float())) for x in leaves]
    if mesh is not None:
        sums = [mesh.psum(t, a) for t, a in zip(sums, axes, strict=True)]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), norm).  As in the
    reference, a leaf comes back in the promoted type of its dtype and
    float32."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale, tree), norm
