"""Federated-learning simulation for DAEF (paper §4.3, Fig. 3); counterpart
of ``repro/core/federated.py``.

Two protocols are provided:

* **Broker protocol (paper-as-written)** — every node trains a full local
  DAEF on its own partition, publishes its privacy-safe state (encoder
  (U, S) factors + per-layer ROLANN knowledge) through a broker, and
  subscribers aggregate it into their model (`broker_round`).  Decoder
  statistics were computed against local encoders, so the aggregate is an
  approximation (the paper's operating mode).

* **Layer-synchronized protocol (`_federated_fit`)** — nodes aggregate the
  encoder first, then proceed layer by layer, each time aggregating the
  ROLANN knowledge before solving.  With shared stage-1 randomness this
  reproduces the centralized solution *exactly* (up to float error).  On
  the fused backend each site's per-layer statistics are one launch of the
  B1 kernel (``rolann.compute_stats``).

Messages contain only mergeable sufficient statistics whose size is
independent of the number of local samples — never raw data (§5).  Entry
points that take data take ``device=`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import daef, dsvd, elm_ae, rolann
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class ModelUpdate:
    """What a node publishes through the broker (paper §5.1)."""

    encoder_factors: dsvd.SvdFactors
    layer_knowledge: tuple  # per decoder layer: RolannStats | RolannFactors
    n_samples: int          # bookkeeping only (not needed for the math)

    def nbytes(self) -> int:
        leaves = [*self.encoder_factors]
        for k in self.layer_knowledge:
            leaves.extend(k)
        return sum(t.numel() * t.element_size() for t in leaves)


def publish(model: daef.DAEFModel) -> ModelUpdate:
    return ModelUpdate(
        encoder_factors=model.encoder_factors,
        layer_knowledge=model.layer_knowledge,
        n_samples=int(model.train_errors.shape[0]),
    )


def broker_round(
    config: daef.DAEFConfig,
    local: daef.DAEFModel,
    updates: Sequence[ModelUpdate],
) -> daef.DAEFModel:
    """Aggregate broker updates into a local model (paper-as-written), on
    the local model's device."""
    merged = local
    errors = local.train_errors
    for upd in updates:
        remote = daef.DAEFModel(
            weights=local.weights,            # placeholder; re-solved in merge
            biases=local.biases,
            encoder_factors=upd.encoder_factors,
            layer_knowledge=upd.layer_knowledge,
            train_errors=torch.zeros((0,), dtype=errors.dtype, device=errors.device),
        )
        merged = daef.merge_models(config, merged, remote)
    return merged


def train_locally_and_aggregate(
    config: daef.DAEFConfig, partitions: Sequence, *, device=None
) -> daef.DAEFModel:
    """Paper-as-written federation: independent local fits + broker merge."""
    models = [daef.fit(config, p, device=device) for p in partitions]
    agg = models[0]
    for m in models[1:]:
        agg = daef.merge_models(config, agg, m)
    return agg


def federated_fit(
    config: daef.DAEFConfig, partitions: Sequence, *, device=None
) -> daef.DAEFModel:
    """DEPRECATED — use ``DAEFEngine(config, ExecutionPlan(
    merge="sequential"), device=...).session().round(partitions)``
    (`repro_torch.engine`).  Thin shim, identical behavior."""
    from repro_torch import engine as _engine

    _engine.deprecation.warn_once(
        "federated.federated_fit",
        "DAEFEngine(config, ExecutionPlan(merge='sequential'))"
        ".session().round(partitions)",
    )
    eng = _engine.DAEFEngine(config, _engine.ExecutionPlan(merge="sequential"),
                             device=device)
    return eng.session().round(partitions)


def _federated_fit(
    config: daef.DAEFConfig, partitions: Sequence, *, device=None
) -> daef.DAEFModel:
    """Layer-synchronized federation — exact centralized equivalence (the
    engine's FederationSession merge="sequential" path; `federated_fit` is
    its deprecation shim).  The partitions [m0, n_p] (ragged n_p allowed)
    are moved to ``device`` (``None``: the card).

    Communication per round: encoder factors (or Grams) once, then one
    ROLANN knowledge aggregate per decoder layer.
    """
    dev = resolve_device(device)
    partitions = [as_tensor(p, dev) for p in partitions]
    config = config.resolved(dev)
    f_hl, f_ll = daef._acts(config)
    keys = config.layer_keys()
    sizes = config.layer_sizes
    use_gram = config.method == "gram"

    # Round 1: encoder.
    enc = dsvd.dsvd(partitions, rank=sizes[0], method="gram" if use_gram else "svd")
    w_enc = enc.u[:, : config.latent_dim]
    hs = [f_hl.fn(w_enc.T @ p) for p in partitions]

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # Rounds 2..L-1: decoder hidden layers, aggregated before solving.
    for li in range(2, len(sizes) - 1):
        locals_ = [
            elm_ae.layer_knowledge_from_partition(
                keys[li], h, sizes[li], f_hl,
                init=config.init, method=config.method,
                backend=config.stats_backend,
            )
            for h in hs
        ]
        k = _aggregate(locals_, use_gram)
        w, b = elm_ae.layer_from_knowledge(
            k, keys[li], sizes[li - 1], sizes[li], config.lam_hidden, f_hl,
            init=config.init, aux_bias=config.aux_bias, dtype=w_enc.dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w)
        biases.append(b)
        knowledge.append(k)
        hs = [f_hl.fn(w.T @ h + b[:, None]) for h in hs]

    # Final round: last layer against the original inputs.
    locals_ = [
        rolann.compute_stats(h, p, f_ll, backend=config.stats_backend) if use_gram
        else rolann.compute_factors(h, p, f_ll)
        for h, p in zip(hs, partitions, strict=True)
    ]
    k_ll = _aggregate(locals_, use_gram)
    w_ll, b_ll = rolann.solve(k_ll, config.lam_last, gram_solver=config.gram_solver)
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(k_ll)

    errors = [
        torch.mean((f_ll.fn(w_ll.T @ h + b_ll[:, None]) - p) ** 2, dim=0)
        for h, p in zip(hs, partitions, strict=True)
    ]
    return daef.DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=torch.cat(errors),
    )


def _concat_errors(pools: list):
    """Pool per-sample train errors: on the host when every pool is a numpy
    array (the session keeps them there), else on the first tensor's
    device."""
    if all(isinstance(e, np.ndarray) for e in pools):
        return np.concatenate(pools)
    dev = next(e.device for e in pools if isinstance(e, torch.Tensor))
    return torch.cat([torch.as_tensor(e, device=dev) for e in pools])


def merge_exchange_states(config: daef.DAEFConfig, states: Sequence[tuple]):
    """Left-to-right reduce of federated exchange states.

    Each state is the ``(encoder_factors, layer_knowledge, train_errors)``
    triple a site would publish (`daef.merge_knowledge` output).  Merging
    the states and re-solving ONCE (`daef._model_from_knowledge`) matches
    the sequential ``functools.reduce(daef.merge_models, ...)`` chain up to
    float error — the weight solves in that chain never feed back into the
    knowledge.  The statistics merge on their device; the error pools
    concatenate where they lie (see :func:`_concat_errors`).

    This is the refresh path of the async `FederationSession` for
    ``merge="sequential"``/``"pairwise"`` plans: it handles rank-ragged
    factor knowledge (``method="svd"``) and any state count.
    """
    if not states:
        raise ValueError("merge_exchange_states: empty state list")
    merge = rolann.merge_stats if config.method == "gram" else rolann.merge_factors
    enc, knw, _ = states[0]
    for enc_b, knw_b, _ in states[1:]:
        enc = dsvd.merge_pair(enc, enc_b)
        knw = tuple(merge(ka, kb) for ka, kb in zip(knw, knw_b, strict=True))
    return enc, knw, _concat_errors([e for _, _, e in states])


# ---------------------------------------------------------------------------
# Additive wire form of an exchange state (the secure-aggregation hook)
#
# Pairwise-masked aggregation (`repro_torch.privacy.secagg`) can only blind
# statistics that merge by PLAIN SUM.  An exchange state triple is almost
# that already: gram knowledge (G, M) is additive, the encoder factors are
# additive through their Gram U S^2 U^T, and the per-sample train-error
# pool — which is concatenated, not summed — becomes additive as a
# fixed-bin histogram.
# ---------------------------------------------------------------------------

#: Train-error histogram wire format: counts over EXCHANGE_ERR_BINS bins on
#: [0, EXCHANGE_ERR_CAP] (overflow clipped into the top bin), decoded back
#: into a deterministic EXCHANGE_ERR_POOL-sample pool.  Data-independent so
#: every site bins identically.
EXCHANGE_ERR_BINS = 64
EXCHANGE_ERR_CAP = 4.0
EXCHANGE_ERR_POOL = 256


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def errors_to_histogram(errors) -> np.ndarray:
    """Additive form of a train-error pool: fixed-bin counts (float64)."""
    e = np.clip(np.asarray(_host(errors), np.float64), 0.0,
                EXCHANGE_ERR_CAP * (1 - 1e-9))
    edges = np.linspace(0.0, EXCHANGE_ERR_CAP, EXCHANGE_ERR_BINS + 1)
    return np.histogram(e, bins=edges)[0].astype(np.float64)


def histogram_to_pool(counts) -> np.ndarray:
    """Deterministic inverse-CDF resample of a (summed) error histogram
    into a fixed-size pool — shaped like a train_errors leaf so threshold
    rules (`anomaly.threshold`) consume it unchanged."""
    counts = np.maximum(np.asarray(counts, np.float64), 0.0)
    total = max(float(counts.sum()), 1e-9)
    cdf = np.cumsum(counts) / total
    qs = (np.arange(EXCHANGE_ERR_POOL, dtype=np.float64) + 0.5) \
        / EXCHANGE_ERR_POOL
    idx = np.clip(np.searchsorted(cdf, qs), 0, EXCHANGE_ERR_BINS - 1)
    edges = np.linspace(0.0, EXCHANGE_ERR_CAP, EXCHANGE_ERR_BINS + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers[idx].astype(np.float32)


def exchange_to_additive(config: daef.DAEFConfig, state: tuple) -> list:
    """Flatten an exchange state triple into purely-additive numpy leaves:
    ``[enc Gram, (G, M) per layer ..., error histogram]``.  Summing the
    leaf lists of several sites and converting back with
    `additive_to_exchange` equals merging the states (up to the lossy
    error-pool histogram, which is the price of broker-blinding).

    The encoder's U S² Uᵀ is formed in the factors' dtype on their device,
    as the reference forms it, and every statistics leaf comes to the host
    in one copy."""
    if config.method != "gram":
        raise ValueError(
            "exchange_to_additive: factor-form knowledge (method='svd') "
            "does not merge by plain sum and cannot ride an additive wire "
            "— use method='gram'"
        )
    enc, knowledge, errors = state
    device_leaves = [(enc.u * (enc.s * enc.s)[..., None, :]) @ enc.u.T]
    for k in knowledge:
        if not isinstance(k, rolann.RolannStats):
            raise ValueError(
                "exchange_to_additive: expected gram RolannStats knowledge, "
                f"got {type(k).__name__}"
            )
        device_leaves += [k.g, k.m]
    dtype = device_leaves[0].dtype
    for t in device_leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)  # exact: every leaf keeps its value
    flat = _host(torch.cat([t.reshape(-1).to(dtype) for t in device_leaves]))
    leaves, start = [], 0
    for t in device_leaves:
        leaves.append(flat[start:start + t.numel()].reshape(tuple(t.shape)))
        start += t.numel()
    leaves.append(errors_to_histogram(errors))
    return leaves


def additive_to_exchange(config: daef.DAEFConfig, leaves: list, *, device=None) -> tuple:
    """Invert `exchange_to_additive` on an aggregated leaf list: eigh the
    summed encoder Gram back to factors (full rank — already padded),
    rebuild the per-layer stats (float32, on ``device``; ``None``: the
    card), resample the error pool (on the host)."""
    n_layers = len(config.layer_sizes) - 2
    if len(leaves) != 2 + 2 * n_layers:
        raise ValueError(
            f"additive_to_exchange: expected {2 + 2 * n_layers} leaves for "
            f"{n_layers} decoder layers, got {len(leaves)}"
        )
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    enc = dsvd.gram_to_factors(f32(leaves[0]))
    knowledge = tuple(
        rolann.RolannStats(g=f32(leaves[1 + 2 * i]), m=f32(leaves[2 + 2 * i]))
        for i in range(n_layers)
    )
    return enc, knowledge, histogram_to_pool(leaves[-1])


def _aggregate(items: list, use_gram: bool):
    if use_gram:
        agg = items[0]
        for it in items[1:]:
            agg = rolann.merge_stats(agg, it)
        return agg
    return rolann.merge_factors_list(items)
