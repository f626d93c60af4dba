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

A tenant fleet calls the ``_batched`` twins of all three by name, with a
leading tenant axis [K] on every tensor: :func:`gram_stats_batched` (B4 on
the fused backend), :func:`gram_stats_acc_batched` (B5) and
:func:`fused_chunk_acc_batched` (B6).  The reference reaches them through
``custom_vmap`` rules on the one-tenant entry points; the port has no vmap
and writes the batch axis out instead.
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


def gram_stats_batched(
    xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor, *,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tenant-batched (G, M): xa [k, m, n], fsq/fd [k, o, n] -> G [k, o, m, m],
    M [k, o, m].  One launch of the B4 kernel on the fused backend."""
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_stats_batched

        return rolann_stats_batched(xa, fsq, fd)
    g = torch.einsum("kin,kon,kjn->koij", xa, fsq, xa)
    m = torch.einsum("kin,kon->koi", xa, fd)
    return g, m


def gram_stats_acc_batched(
    g: torch.Tensor, m: torch.Tensor, xa: torch.Tensor, fsq: torch.Tensor,
    fd: torch.Tensor, *, backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tenant-batched fold, in place: g [k, o, mm, mm], m [k, o, mm] +=
    (G, M) of xa [k, mm, n_chunk], fsq/fd [k, o, n_chunk].  One launch of the
    B5 kernel on the fused backend."""
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_stats_acc_batched

        return rolann_stats_acc_batched(g, m, xa, fsq, fd)
    g.add_(torch.einsum("kin,kon,kjn->koij", xa, fsq, xa))
    m.add_(torch.einsum("kin,kon->koi", xa, fd))
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


def _fused_chunk_acc_batched_einsum(g, m, h, w, b, mask, act: activations.Activation):
    """The einsum route of :func:`fused_chunk_acc_batched`, in the inputs'
    dtype, folded into ``g``, ``m`` in place — also the plain version of the
    B6 kernel (``rolann_fused_chunk_batched_plain`` runs it in float32).
    The reference's op order: stage-1 product and bias, activation, targets
    (clip, inv, deriv, fsq, fd), then the mask."""
    h_c1 = act.fn(torch.einsum("kim,kin->kmn", w, h) + b[:, :, None])  # [k, m_c1, n]
    ones = torch.ones((h_c1.shape[0], 1, h_c1.shape[2]), dtype=h_c1.dtype,
                      device=h_c1.device)
    xa = torch.cat([h_c1, ones], dim=1)
    fsq, fd = _fused_chunk_targets(h, act)
    fsq = fsq * mask[:, None, :]
    fd = fd * mask[:, None, :]
    g.add_(torch.einsum("kin,kon,kjn->koij", xa, fsq, xa))
    m.add_(torch.einsum("kin,kon->koi", xa, fd))
    return g, m


def fused_chunk_acc_batched(
    g: torch.Tensor, m: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
    b: torch.Tensor, mask: torch.Tensor | None = None, *, act,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tenant-batched fused chunk fold, in place: g [k, o, ma, ma],
    m [k, o, ma]; h [k, m_l, n]; every tenant's own stage-1 encoder
    w [k, m_l, m_c1], b [k, m_c1]; mask [k, n] or None (all ones).  One
    launch of the B6 kernel for the whole fleet's chunk on the fused
    backend.  The reference takes b as [k, m_c1] here too; its kernel's
    [k, m_c1, 1] and [k, 1, n] layouts are the wrapper's business.  Like
    the reference's, it does not refuse the linear activation itself: the
    einsum route folds it, the kernel's wrapper raises."""
    act_name = act if isinstance(act, str) else act.name
    if mask is None:
        mask = torch.ones((h.shape[0], h.shape[2]), dtype=h.dtype, device=h.device)
    else:
        mask = torch.as_tensor(mask, device=h.device).to(h.dtype)
    if resolve(backend) == "fused":
        from repro_torch.kernels.rolann_stats import rolann_fused_chunk_batched

        return rolann_fused_chunk_batched(g, m, h, w, b, mask, act_name=act_name)
    return _fused_chunk_acc_batched_einsum(
        g, m, h, w, b, mask, activations.get(act_name, invertible_required=True)
    )


__all__ = ["AUTO", "BACKENDS", "DEFAULT", "ENV_VAR", "fused_chunk_acc",
           "fused_chunk_acc_batched", "gram_stats", "gram_stats_acc",
           "gram_stats_acc_batched", "gram_stats_batched", "resolve"]
