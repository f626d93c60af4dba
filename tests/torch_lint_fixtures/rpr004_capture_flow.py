"""RPR004 fixture (the port's): python control flow on tensors inside a
capture."""
import torch


def bad_if_on_param(g, x):
    with torch.cuda.graph(g):
        if x.sum() > 0:                                      # line 8: RPR004
            x.neg_()


def bad_while_on_derived(g, x):
    acc = torch.zeros_like(x)
    with torch.cuda.graph(g):
        while acc.max() < 1.0:                               # line 15: RPR004
            acc.add_(x)


def clean_static_branch(g, x):
    with torch.cuda.graph(g):
        if x.shape[0] > 2 and x.ndim == 2 and isinstance(x, torch.Tensor):
            x.mul_(2)


def clean_branch_outside(g, x):
    if x.sum() > 0:                   # eager, before the capture
        x.neg_()
    with torch.cuda.graph(g):
        x.mul_(torch.where(x > 0, 1.0, -1.0))
