"""Minimal optimiser library over the port's parameter trees.

Counterpart of ``repro/optim``, with the same (init, update) style:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Trees are the port's nested dicts (and lists) of tensors, walked with
``torch.utils._pytree``.  The arithmetic follows the reference leaf by leaf
(float32 moments, bias correction by the float32 step, updates in the
parameter's dtype).  Unlike the reference's pure functions, the optimiser
states are updated in place and ``apply_updates`` adds to the parameters in
place (under ``torch.no_grad``), as ``torch.optim`` does: a full-width model
keeps one copy of its moments and parameters on the card, not two.
"""
from repro_torch.optim.adam import AdamState, adam, adamw
from repro_torch.optim.base import Optimizer, apply_updates, clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine
from repro_torch.optim.sgd import SgdState, sgd

__all__ = ["AdamState", "Optimizer", "SgdState", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "cosine_decay", "global_norm",
           "linear_warmup_cosine", "sgd"]
