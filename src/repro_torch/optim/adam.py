"""Adam / AdamW (counterpart of ``repro/optim/adam.py``).

Moments are kept in float32 whatever the parameters' dtype (bf16-safe), the
mixed-precision recipe the train step relies on; ``moments_dtype`` stores
them rounded (the math stays float32).  ``update`` writes the new moments
into the state's tensors in place and returns the state with them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim.base import Optimizer
from repro_torch.optim.schedules import constant


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def adam(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moments_dtype=torch.float32,
) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moments_dtype, device=p.device)

        device = pytree.tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                         mu=pytree.tree_map(zeros, params), nu=pytree.tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        step = state.step + 1
        stepf = step.float()
        lr_t = lr_fn(stepf)
        bc1 = 1.0 - b1**stepf
        bc2 = 1.0 - b2**stepf

        def one(g, m, v, p):
            g = g.float()
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            upd = -lr_t * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                           + weight_decay * p.float())
            m.copy_(m32)
            v.copy_(v32)
            # Emitted in the parameter's dtype, as the reference emits it.
            return upd.to(p.dtype)

        g_leaves, spec = pytree.tree_flatten(grads)
        updates = [one(g, m, v, p) for g, m, v, p in zip(
            g_leaves, pytree.tree_leaves(state.mu), pytree.tree_leaves(state.nu),
            pytree.tree_leaves(params), strict=True)]
        return pytree.tree_unflatten(updates, spec), AdamState(step=step, mu=state.mu,
                                                               nu=state.nu)

    return Optimizer(init=init, update=update)
