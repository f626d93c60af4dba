"""Pluggable backend for the per-output Gram sufficient statistics.

Counterpart of ``repro/core/stats_backend.py``.  DAEF's training cost is
dominated by the per-layer statistics

    G[o] = Xa · diag(f'²[o]) · Xaᵀ        [o, m, m]
    M[o] = Xa · (f'²[o] ∘ d̄[o])           [o, m]

which :func:`gram_stats` computes with one of two backends:

* ``"einsum"`` — two plain torch einsums in the input dtype;
* ``"fused"``  — the hand-written ``rolann_stats`` CUDA kernel
  (``kernels/rolann_stats``); for CPU tensors its wrapper runs the plain
  version with the kernel's float32 contract.
* ``"auto"``   — resolves to ``"einsum"``: no H100 measurement has chosen a
  winner yet (the reference's ``_resolve_auto`` does the same for platforms
  its autotune cache has not measured).  It never reaches a kernel.

Selection precedence: explicit ``backend=`` (or a non-None
``DAEFConfig.stats_backend``) > ``$REPRO_STATS_BACKEND`` > ``"auto"``.

The streaming fit folds chunk by chunk through two more entry points, both
updating their running accumulators **in place** and returning them (the
reference donated them to each jitted step):

* :func:`gram_stats_acc` — (G, M) of one chunk added into ``g``, ``m``; the
  ``rolann_stats_acc`` CUDA kernel (B2) on the fused backend;
* :func:`fused_chunk_acc` — the whole fold of one ELM-AE chunk (stage-1
  product and activation, target transform, mask, (G, M)); the
  ``rolann_fused_chunk`` CUDA kernel (B3) on the fused backend, whose plain
  version is this module's einsum route.

The tenant-batched entry points and their vmap rules wait for the fleet
slice (ROADMAP queue A item 8).
"""
from __future__ import annotations

import os

import torch

from repro_torch.core import activations

#: Concrete backends a call can dispatch to; ``AUTO`` is collapsed first.
BACKENDS = ("einsum", "fused")
AUTO = "auto"
ENV_VAR = "REPRO_STATS_BACKEND"
DEFAULT = AUTO


def _resolve_auto() -> str:
    return "einsum"


def resolve(backend: str | None = None) -> str:
    """Concrete backend name: explicit arg > $REPRO_STATS_BACKEND > "auto"."""
    if backend is None:
        backend = os.environ.get(ENV_VAR) or DEFAULT
    if backend == AUTO:
        return _resolve_auto()
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown stats backend {backend!r}: choose from "
            f"{(*BACKENDS, AUTO)} (explicitly or via ${ENV_VAR})"
        )
    return backend


def gram_stats(
    xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor, *,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, M) per-output statistics for xa [m, n], fsq/fd [o, n]."""
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_stats

        return rolann_stats(xa, fsq, fd)
    g = torch.einsum("in,on,jn->oij", xa, fsq, xa)
    m = torch.einsum("in,on->oi", xa, fd)
    return g, m


def gram_stats_acc(
    g: torch.Tensor, m: torch.Tensor, xa: torch.Tensor, fsq: torch.Tensor,
    fd: torch.Tensor, *, backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one sample chunk into running stats: (g, m) += (G, M) of the chunk.

    g [o, mm, mm], m [o, mm] are the running accumulators (mm = rows of xa);
    xa [mm, n_chunk]; fsq, fd [o, n_chunk].  Both backends update ``g`` and
    ``m`` in place and return them.
    """
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_stats_acc

        return rolann_stats_acc(g, m, xa, fsq, fd)
    g.add_(torch.einsum("in,on,jn->oij", xa, fsq, xa))
    m.add_(torch.einsum("in,on->oi", xa, fd))
    return g, m


def _fused_chunk_targets(h: torch.Tensor, act: activations.Activation):
    """Target transform of an ELM-AE chunk fold (the targets ARE the layer
    input), in ``rolann.accumulate_stats``' order: clip, inv, deriv, fsq, fd."""
    d = act.clip_to_range(h)
    dbar = act.inv(d)
    fp = act.deriv(dbar)
    fsq = fp * fp
    fd = fsq * dbar
    return fsq, fd


def _fused_chunk_acc_unbatched(g, m, h, w, b, mask, act: activations.Activation):
    """The einsum route of :func:`fused_chunk_acc`, in the inputs' dtype,
    folded into ``g``, ``m`` in place — also the plain version of the B3
    kernel (``rolann_fused_chunk_plain`` runs it in float32)."""
    h_c1 = act.fn(w.T @ h + b[:, None])                      # [m_c1, n]
    ones = torch.ones((1, h_c1.shape[1]), dtype=h_c1.dtype, device=h_c1.device)
    xa = torch.cat([h_c1, ones])
    fsq, fd = _fused_chunk_targets(h, act)
    fsq = fsq * mask[None, :]
    fd = fd * mask[None, :]
    g.add_(torch.einsum("in,on,jn->oij", xa, fsq, xa))
    m.add_(torch.einsum("in,on->oi", xa, fd))
    return g, m


def fused_chunk_acc(
    g: torch.Tensor, m: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
    b: torch.Tensor, mask: torch.Tensor | None = None, *, act,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one streamed chunk's layer stats in ONE call, in place.

    g [o, ma, ma], m [o, ma] running accumulators (o == rows of h, ma ==
    cols of w + 1); h [m_l, n_chunk] the chunk's layer input (ELM-AE targets
    are the input itself); w [m_l, m_c1], b [m_c1] the stage-1 encoder;
    mask [n_chunk] sample weights (None -> all ones).  ``act`` is an
    activation name or ``activations.Activation``; the linear activation has
    a cheaper shared-F closed form in ``rolann.accumulate_stats`` and is
    rejected here.  Both backends update ``g`` and ``m`` in place and return
    them; on the fused backend the fold is one launch of the B3 kernel, and
    the activation never reaches device memory.
    """
    act_name = act if isinstance(act, str) else act.name
    if act_name == "linear":
        raise ValueError(
            "fused_chunk_acc handles non-linear activations; the linear "
            "layer uses the shared-F path in rolann.accumulate_stats"
        )
    if mask is None:
        mask = torch.ones((h.shape[1],), dtype=h.dtype, device=h.device)
    else:
        mask = torch.as_tensor(mask, device=h.device).to(h.dtype)
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_fused_chunk

        return rolann_fused_chunk(g, m, h, w, b, mask, act_name=act_name)
    return _fused_chunk_acc_unbatched(
        g, m, h, w, b, mask, activations.get(act_name, invertible_required=True)
    )


__all__ = ["AUTO", "BACKENDS", "DEFAULT", "ENV_VAR", "fused_chunk_acc", "gram_stats",
           "gram_stats_acc", "resolve"]
