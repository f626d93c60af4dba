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
    k_w, k_b = threefry.split(torch.tensor(key_words, dtype=torch.int64))
    w_c1 = initializers.get(init)(k_w, (m_in, m_out), dtype)
    b_c1 = threefry.normal(k_b, (m_out,), dtype)  # N(0, 1) per the paper
    return w_c1.to(device), b_c1.to(device)


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
