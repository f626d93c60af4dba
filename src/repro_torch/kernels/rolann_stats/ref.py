"""Plain PyTorch version of the ROLANN sufficient statistics.

Given the augmented input matrix ``xa`` [m, n], per-output derivative squares
``fsq`` [o, n] and weighted targets ``fd = f'^2 * dbar`` [o, n]:

    G[o] = xa @ diag(fsq[o]) @ xa^T      [o, m, m]
    M[o] = xa @ fd[o]                    [o, m]

— the paper's Eq. 6-7 in Gram form.  Counterpart of
``repro/kernels/rolann_stats/ref.py``; the CUDA kernel beside it is held
against this function.
"""
from __future__ import annotations

import torch


def rolann_stats_ref(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    g = torch.einsum("in,on,jn->oij", xa, fsq, xa)
    m = torch.einsum("in,on->oi", xa, fd)
    return g, m
