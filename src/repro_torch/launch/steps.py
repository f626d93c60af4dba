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
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import optim
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
        if clip_norm is not None:
            # Scale the gradients in place instead of keeping a clipped copy.
            norm = optim.global_norm(grads)
            scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        updates, opt_state = opt.update(pytree.tree_unflatten(grads, spec), opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


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
