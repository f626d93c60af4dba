"""SGD with optional (Nesterov) momentum (counterpart of
``repro/optim/sgd.py``).  The float32 momentum is updated in place."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim.base import Optimizer
from repro_torch.optim.schedules import constant


class SgdState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    momentum: Any


def sgd(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    momentum: float = 0.0,
    nesterov: bool = False,
) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params):
        step = torch.zeros((), dtype=torch.int32,
                           device=pytree.tree_leaves(params)[0].device)
        if momentum == 0.0:
            return SgdState(step=step, momentum=None)
        return SgdState(step=step, momentum=pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    @torch.no_grad()
    def update(grads, state: SgdState, params):
        del params
        step = state.step + 1
        lr_t = lr_fn(step.float())
        if momentum == 0.0:
            return pytree.tree_map(lambda g: -lr_t * g.float(), grads), \
                SgdState(step=step, momentum=None)

        def one(m, g):
            m.copy_(momentum * m + g.float())
            if nesterov:
                return -lr_t * (momentum * m + g.float())
            return -lr_t * m

        g_leaves, spec = pytree.tree_flatten(grads)
        updates = [one(m, g) for m, g in zip(pytree.tree_leaves(state.momentum), g_leaves,
                                             strict=True)]
        return pytree.tree_unflatten(updates, spec), SgdState(step=step,
                                                              momentum=state.momentum)

    return Optimizer(init=init, update=update)
