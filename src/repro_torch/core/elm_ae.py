"""TLD — Train one Layer of the Decoder via an auxiliary ELM-AE (paper Alg. 2).

Counterpart of ``repro/core/elm_ae.py``.  For the decoder weights between
layers l and l+1 an auxiliary single-hidden-layer autoencoder is built:

  stage 1 (c0 -> c1):  fixed random weights W_c1 (Xavier by default) and bias
                       b_c1, drawn from the layer's key;
                       H_c1 = f(W_c1^T H_l + b_c1 1^T)
  stage 2 (c1 -> c2):  ROLANN solves the reconstruction H_c1 -> H_l in closed
                       form; its weights transposed are the decoder layer.

``aux_bias`` is ``"zero"`` (no decoder bias, default) or ``"c1"`` (reuse the
auxiliary random bias).

The streaming fit trains the same layer as a fold: chunk by chunk
:func:`accumulate_layer_stats` adds the layer's ROLANN statistics in place,
and :func:`layer_from_knowledge` solves the weights from their sum.

A tenant fleet trains one layer of every tenant at once: the ``_batched``
functions take a leading tenant axis [K] on every tensor, one key per tenant
[K, 2] and one lambda per tenant [K] (the reference vmaps the one-tenant
functions instead).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import activations, initializers, rolann, stats_backend, threefry


class LayerResult(NamedTuple):
    w: torch.Tensor            # [m_l, m_{l+1}] decoder weights for layer l+1
    b: torch.Tensor            # [m_{l+1}] decoder bias
    h: torch.Tensor            # [m_{l+1}, n] layer output on the training data
    knowledge: rolann.RolannStats  # federated state


def stage1(
    key: torch.Tensor,
    m_in: int,
    m_out: int,
    init: str,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed random stage-1 parameters (shared across federated nodes),
    drawn on the host with the reference's bits, then moved to ``device``.

    The draw is a pure function of its arguments and costs a few hundred
    small host ops, so it is kept (per device, for the last 64 argument
    sets): a refit with the same seed, as every federated round is, reuses
    it.  The caller gets its own copy.
    """
    key_words = tuple(int(v) for v in key.reshape(2).tolist())
    w_c1, b_c1 = _stage1_cached(key_words, m_in, m_out, init, dtype, torch.device(device))
    return w_c1.clone(), b_c1.clone()


@functools.lru_cache(maxsize=64)
def _stage1_cached(key_words, m_in, m_out, init, dtype, device):
    return _draw(torch.tensor(key_words, dtype=torch.int64), m_in, m_out, init, dtype,
                 device)


def _draw(key, m_in, m_out, init, dtype, device):
    """W_c1 and b_c1 of ``key`` [2], or of every key of a batch [K, 2]."""
    keys = threefry.split(key)                   # [(K,) 2, 2]
    k_w, k_b = keys[..., 0, :], keys[..., 1, :]
    w_c1 = initializers.get(init)(k_w, (m_in, m_out), dtype)
    b_c1 = threefry.normal(k_b, (m_out,), dtype)  # N(0, 1) per the paper
    return w_c1.to(device), b_c1.to(device)


def stage1_batched(
    keys: torch.Tensor,
    m_in: int,
    m_out: int,
    init: str,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`stage1` for every tenant of a fleet layer in one draw:
    ``keys`` [K, 2] -> W_c1 [K, m_in, m_out], b_c1 [K, m_out], the values
    ``jax.vmap(elm_ae.stage1)`` gives and, tenant by tenant, the same bits
    as :func:`stage1` of that tenant's key.

    Kept like :func:`stage1`'s draws, one entry per (key batch, widths,
    init, dtype, device), for the last 16 such sets: a refit of the same
    fleet reuses them.  The caller gets its own copy.
    """
    key_words = tuple(tuple(int(v) for v in k) for k in keys.reshape(-1, 2).tolist())
    w_c1, b_c1 = _stage1_batched_cached(key_words, m_in, m_out, init, dtype,
                                        torch.device(device))
    return w_c1.clone(), b_c1.clone()


@functools.lru_cache(maxsize=16)
def _stage1_batched_cached(key_words, m_in, m_out, init, dtype, device):
    return _draw(torch.tensor(key_words, dtype=torch.int64), m_in, m_out, init, dtype,
                 device)


def train_layer(
    key: torch.Tensor,
    h_l: torch.Tensor,
    m_next: int,
    lam: float,
    act: activations.Activation,
    *,
    init: str = "xavier",
    aux_bias: str = "zero",
    method: str = "gram",
    backend: str | None = None,
    gram_solver: str = "chol",
) -> LayerResult:
    """Alg. 2: train the decoder layer mapping H_l [m_l, n] -> H_{l+1}."""
    m_l = h_l.shape[0]
    w_c1, b_c1 = stage1(key, m_l, m_next, init, h_l.dtype, h_l.device)
    h_c1 = act.fn(w_c1.T @ h_l + b_c1[:, None])  # [m_next, n]

    # rolann.fit returns W [inputs=m_next, outputs=m_l]; the decoder layer is
    # its transpose (the ELM-AE transpose trick, Eq. 4).
    w_c2, _b_c2, knowledge = rolann.fit(
        h_c1, h_l, act, lam, method=method, backend=backend,
        gram_solver=gram_solver,
    )
    w_next = w_c2.T  # [m_l, m_next]
    if aux_bias == "zero":
        b_next = torch.zeros((m_next,), dtype=h_l.dtype, device=h_l.device)
    elif aux_bias == "c1":
        b_next = b_c1
    else:
        raise ValueError(f"unknown aux_bias {aux_bias!r}")

    h_next = act.fn(w_next.T @ h_l + b_next[:, None])
    return LayerResult(w=w_next, b=b_next, h=h_next, knowledge=knowledge)


def accumulate_layer_stats(
    stats: rolann.RolannStats,
    w_c1: torch.Tensor,
    b_c1: torch.Tensor,
    h_l: torch.Tensor,
    act: activations.Activation,
    *,
    weights: torch.Tensor | None = None,
    backend: str | None = None,
) -> rolann.RolannStats:
    """Streaming building block: fold one sample chunk of layer inputs
    ``h_l`` [m_l, n_chunk] into the decoder layer's running ROLANN
    statistics, **in place** (``stats.g`` and ``stats.m`` are updated and
    ``stats`` is returned).

    Summed over all chunks this equals :func:`train_layer`'s one-shot
    statistics, so the solved weights match the non-streaming fit.
    ``weights`` masks padded sample columns.  On the fused backend with a
    non-linear activation the whole fold — stage-1 product, activation,
    target transform and (G, M) — is ONE ``stats_backend.fused_chunk_acc``
    call, the B3 kernel; otherwise the stage-1 activation is formed here and
    folded by ``rolann.accumulate_stats``.
    """
    resolved = stats_backend.resolve(backend)
    if resolved == "fused" and act.name != "linear":
        stats_backend.fused_chunk_acc(stats.g, stats.m, h_l, w_c1, b_c1, weights,
                                      act=act, backend=resolved)
        return stats
    h_c1 = act.fn(w_c1.T @ h_l + b_c1[:, None])
    return rolann.accumulate_stats(stats, h_c1, h_l, act, weights=weights,
                                   backend=resolved)


def layer_from_knowledge(
    knowledge: rolann.RolannStats,
    key: torch.Tensor,
    m_l: int,
    m_next: int,
    lam: float,
    act: activations.Activation,
    *,
    init: str = "xavier",
    aux_bias: str = "zero",
    dtype: torch.dtype = torch.float32,
    gram_solver: str = "chol",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the decoder layer weights from (merged) knowledge, on its device."""
    del act  # the reference's signature; the solve does not need it
    w_c2, _ = rolann.solve(knowledge, lam, gram_solver=gram_solver)
    w_next = w_c2.T
    device = knowledge.m.device
    if aux_bias == "zero":
        b_next = torch.zeros((m_next,), dtype=dtype, device=device)
    elif aux_bias == "c1":
        _, b_next = stage1(key, m_l, m_next, init, dtype, device)
    else:
        raise ValueError(f"unknown aux_bias {aux_bias!r}")
    return w_next, b_next


def train_layer_batched(
    keys: torch.Tensor,
    h_l: torch.Tensor,
    m_next: int,
    lam,
    act: activations.Activation,
    *,
    init: str = "xavier",
    aux_bias: str = "zero",
    backend: str | None = None,
    gram_solver: str = "chol",
) -> LayerResult:
    """:func:`train_layer` for every tenant of a fleet: keys [K, 2], h_l
    [K, m_l, n], lam scalar or [K] -> w [K, m_l, m_next], b [K, m_next],
    h [K, m_next, n] and knowledge with a leading [K].  One stage-1 draw,
    one statistics call (B4 on the fused backend) and one solve."""
    m_l = h_l.shape[1]
    w_c1, b_c1 = stage1_batched(keys, m_l, m_next, init, h_l.dtype, h_l.device)
    h_c1 = act.fn(w_c1.transpose(-1, -2) @ h_l + b_c1[..., None])  # [K, m_next, n]
    knowledge = rolann.compute_stats_batched(h_c1, h_l, act, backend=backend)
    w_c2, _ = rolann.solve(knowledge, lam, gram_solver=gram_solver,
                           shared_f=act.name == "linear")
    w_next = w_c2.transpose(-1, -2)  # [K, m_l, m_next]
    if aux_bias == "zero":
        b_next = torch.zeros_like(b_c1)
    elif aux_bias == "c1":
        b_next = b_c1
    else:
        raise ValueError(f"unknown aux_bias {aux_bias!r}")
    h_next = act.fn(w_next.transpose(-1, -2) @ h_l + b_next[..., None])
    return LayerResult(w=w_next, b=b_next, h=h_next, knowledge=knowledge)


def accumulate_layer_stats_batched(
    stats: rolann.RolannStats,
    w_c1: torch.Tensor,
    b_c1: torch.Tensor,
    h_l: torch.Tensor,
    act: activations.Activation,
    *,
    weights: torch.Tensor | None = None,
    backend: str | None = None,
) -> rolann.RolannStats:
    """:func:`accumulate_layer_stats` for every tenant at once, in place:
    w_c1 [K, m_l, m_c1], b_c1 [K, m_c1], h_l [K, m_l, n_chunk], weights
    [K, n_chunk].  On the fused backend with a non-linear activation the
    whole fold is one launch of the B6 kernel."""
    resolved = stats_backend.resolve(backend)
    if resolved == "fused" and act.name != "linear":
        stats_backend.fused_chunk_acc_batched(stats.g, stats.m, h_l, w_c1, b_c1, weights,
                                              act=act, backend=resolved)
        return stats
    h_c1 = act.fn(w_c1.transpose(-1, -2) @ h_l + b_c1[..., None])
    return rolann.accumulate_stats_batched(stats, h_c1, h_l, act, weights=weights,
                                           backend=resolved)


def layer_from_knowledge_batched(
    knowledge: rolann.RolannStats,
    keys: torch.Tensor,
    m_l: int,
    m_next: int,
    lam,
    act: activations.Activation,
    *,
    init: str = "xavier",
    aux_bias: str = "zero",
    dtype: torch.dtype = torch.float32,
    gram_solver: str = "chol",
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`layer_from_knowledge` for every tenant: knowledge with a
    leading [K], keys [K, 2], lam scalar or [K] -> w [K, m_l, m_next],
    b [K, m_next]."""
    w_c2, _ = rolann.solve(knowledge, lam, gram_solver=gram_solver,
                           shared_f=act.name == "linear")
    w_next = w_c2.transpose(-1, -2)
    device = knowledge.m.device
    if aux_bias == "c1":
        _, b_c1 = stage1_batched(keys, m_l, m_next, init, dtype, device)
        return w_next, b_c1
    if aux_bias != "zero":
        raise ValueError(f"unknown aux_bias {aux_bias!r}")
    return w_next, torch.zeros((keys.shape[0], m_next), dtype=dtype, device=device)
