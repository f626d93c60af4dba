"""Step functions: train (with microbatch gradient accumulation), prefill
and decode (counterpart of ``repro/launch/steps.py``).

The train step folds the optimiser update in: (params, opt_state, batch) ->
(params, opt_state, loss).  Microbatching splits the batch's leading axis
into ``microbatches`` equal parts, runs them one after another and
accumulates their gradients in ``accum_dtype``; peak live activations are
one microbatch's.  Gradients come from ``torch.autograd.grad`` of
``bundle.loss`` with respect to every parameter leaf: a leaf the loss does
not reach (an attention output cut from the graph, say) raises there.

The step sets ``requires_grad`` on the parameter leaves (``bundle.init``
makes them under ``no_grad``), and the optimiser updates them and its state
in place (``repro_torch.optim``).

Under a mesh (``models.hints.use_mesh``; the dense family) the step takes
this rank's slices of the parameters and state and this rank's rows of the
batch, split into the microbatches.  A rank's loss is the mean over its
rows, so the step's loss is the mean over the data ranks, and so is each
gradient: a leaf that every data rank holds whole has its gradient summed
over the data axes, a leaf split over ``data`` (FSDP) had it summed over
them in the backward, and each is divided by the data extent.  The global
norm sums each leaf's squares over exactly the axes it is split over
(``optim.global_norm``), so clipping, and AdamW on the slices, match one
device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import optim
from repro_torch.launch.mesh import data_axes
from repro_torch.models import hints
from repro_torch.models.api import ModelBundle


def _split(batch, microbatches: int) -> list:
    def part(x, i):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        n = b // microbatches
        return x[i * n:(i + 1) * n]

    return [pytree.tree_map(lambda x, i=i: part(x, i), batch) for i in range(microbatches)]


def make_train_step(
    bundle: ModelBundle,
    opt: optim.Optimizer,
    *,
    microbatches: int = 1,
    clip_norm: float | None = 1.0,
    accum_dtype=torch.float32,
) -> Callable:
    """``accum_dtype``: dtype of the microbatch gradient accumulator (with
    one microbatch the gradients keep the parameters' dtype, as in the
    reference)."""

    def train_step(params, opt_state, batch):
        leaves, spec = pytree.tree_flatten(params)
        mesh = hints.active_mesh()
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss = bundle.loss(params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in _split(batch, microbatches):
                mb_loss = bundle.loss(params, mb)
                for acc, g in zip(grads, torch.autograd.grad(mb_loss, leaves), strict=True):
                    acc.add_(g.to(accum_dtype))
                loss = loss + mb_loss.detach()
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
        axes = None
        if mesh is not None and mesh.size > 1:
            loss, grads, axes = _data_mean(bundle, mesh, params, loss, grads)
        if clip_norm is not None:
            # Scale the gradients in place instead of keeping a clipped copy.
            norm = (optim.global_norm(grads) if axes is None
                    else optim.global_norm(grads, axes=axes, mesh=mesh))
            scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        updates, opt_state = opt.update(pytree.tree_unflatten(grads, spec), opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def _data_mean(bundle: ModelBundle, mesh, params, loss, grads):
    """The loss and gradients averaged over the mesh's data axes (module
    docstring), and each leaf's split axes for the global norm."""
    from repro_torch.launch import shardings

    dp = data_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dp)
    specs = shardings.lm_param_specs(bundle.cfg, mesh)

    def leaf_axes(path, _):
        spec = specs
        for key in path:
            spec = spec[key]
        return shardings.spec_axes(spec)

    axes = pytree.tree_leaves(shardings.map_with_path(leaf_axes, params),
                              is_leaf=lambda x: isinstance(x, tuple))
    loss = mesh.psum(loss, dp) / n
    out = []
    for g, a in zip(grads, axes, strict=True):
        g = mesh.psum(g, [d for d in dp if d not in a])
        out.append(g.div_(n) if n > 1 else g)
    return loss, out, axes


def make_prefill_step(bundle: ModelBundle) -> Callable:
    def prefill_step(params, batch):
        return bundle.prefill(params, batch)

    return prefill_step


def make_decode_step(bundle: ModelBundle) -> Callable:
    """(params, cache, token, pos) -> (logits, cache): ``bundle.decode``,
    which updates the cache in place."""
    def decode_step(params, cache, token, pos):
        return bundle.decode(params, cache, token, pos)

    return decode_step
