"""Multi-tenant DAEF fleet: K independent models fitted, merged and scored
together (counterpart of ``repro/core/fleet.py``).

DAEF's closed-form training is cheap enough to run one model *per tenant*
(edge node, device, user), the per-device anomaly-detector pattern.  A
Python loop over ``daef.fit`` costs K times the host dispatch of one fit;
here every step of the fit, the merge and the scoring runs over a leading
tenant axis [K] at once: one stage-1 draw per layer, one statistics launch
per layer (the B4 kernel on the fused backend), one batched Cholesky solve,
one batched quantile.

The reference ``vmap``s its one-tenant cores and reaches the batched
kernels through ``custom_vmap`` rules; the port has no vmap for its ctypes
launches, so the batch axis is written out and the ``_batched`` entry points
(``stats_backend.gram_stats_batched``, ``gram_stats_acc_batched``,
``fused_chunk_acc_batched``; ``elm_ae.*_batched``; ``rolann.*_batched``) are
called by name.

Constraints (the reference's):
  * all tenants share ``layer_sizes`` and the other static config fields
    (activations, init scheme, method);
  * ``lam_hidden`` / ``lam_last`` / ``seed`` may vary per tenant — they are
    [K] tensors;
  * every tenant in one call sees the same number of samples (pad and mask
    via ``fleet_scores``' ``n_valid`` for ragged serving batches).

Data convention matches ``daef``: per-tenant data is [features, samples], a
fleet batch is [tenants, features, samples].

Differences from the reference, on purpose:
  * its ``_require_concrete`` guards the merge checks against JAX tracers;
    torch has none, so it is gone;
  * ``_fit_fleet_stream`` takes ``device=`` where the reference takes
    ``place=`` (its mesh sharding waits for ROADMAP queue A item 12);
  * ``fleet_fit`` calls ``_fit_fleet`` directly: the reference's is a
    deprecation shim onto the engine, which waits for ROADMAP item 9.
Entry points that take data take ``device=`` (``None``: the card).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import anomaly, daef, dsvd, elm_ae, rolann
from repro_torch.device import DEFAULT_DTYPE, as_tensor, resolve_device


class DAEFFleet(NamedTuple):
    """K trained DAEF models, stacked leaf-wise (leading tenant axis), plus
    the per-tenant hyperparameters needed to merge or update them later."""

    model: daef.DAEFModel   # every leaf has a leading [K] axis
    seeds: torch.Tensor     # [K] int32 — per-tenant shared-randomness seeds
    lam_hidden: torch.Tensor  # [K]
    lam_last: torch.Tensor    # [K]

    @property
    def size(self) -> int:
        return self.seeds.shape[0]


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of a fleet or model (NamedTuples and
    tuples), keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_tree_map(fn, t) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _tree_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a fleet or model in ``jax.tree.flatten`` order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _tree_leaves(t)]


def _shape(xs):
    shape = getattr(xs, "shape", None)
    return None if shape is None else tuple(shape)


def _per_tenant(value, default, k: int, dtype, device) -> torch.Tensor:
    """Broadcast a scalar (or pass through a [K] array) of per-tenant values."""
    arr = torch.as_tensor(default if value is None else value, device=device).to(dtype)
    if arr.ndim == 0:
        arr = arr.expand(k).clone()
    if tuple(arr.shape) != (k,):
        raise ValueError(f"per-tenant value must be scalar or [K={k}], got {tuple(arr.shape)}")
    return arr


def _tenant_keys(config: daef.DAEFConfig, seeds: torch.Tensor) -> torch.Tensor:
    """Per-tenant layer keys [K, n_layers, 2] (host tensors)."""
    return daef.layer_keys_from_seed(seeds, len(config.layer_sizes))


def _prepare_fit(config: daef.DAEFConfig, xs, seeds, lam_hidden, lam_last, device):
    """Shared fleet-fit argument validation and per-tenant broadcasting.
    ``xs`` may be a host array; only its shape and dtype are consulted."""
    if getattr(xs, "ndim", None) != 3:
        raise ValueError(f"fleet data must be [K, m0, n], got {_shape(xs)}")
    k = xs.shape[0]
    if xs.shape[1] != config.layer_sizes[0]:
        raise ValueError(
            f"input dim {xs.shape[1]} != layer_sizes[0] {config.layer_sizes[0]}"
        )
    is_float = isinstance(xs, torch.Tensor) and xs.is_floating_point()
    dtype = xs.dtype if is_float else DEFAULT_DTYPE
    return (
        _per_tenant(seeds, config.seed, k, torch.int32, device),
        _per_tenant(lam_hidden, config.lam_hidden, k, dtype, device),
        _per_tenant(lam_last, config.lam_last, k, dtype, device),
    )


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

def _forward(config: daef.DAEFConfig, xs: torch.Tensor, weights, biases) -> torch.Tensor:
    """Every tenant's hidden activations: the encoder (no bias), then the
    decoder layers given (all with the hidden activation)."""
    f_hl, _ = daef._acts(config)
    h = f_hl.fn(weights[0].transpose(-1, -2) @ xs)
    for w, b in zip(weights[1:], biases, strict=True):
        h = f_hl.fn(w.transpose(-1, -2) @ h + b[..., None])
    return h


def _reconstruct(config: daef.DAEFConfig, xs: torch.Tensor, weights, biases) -> torch.Tensor:
    _, f_ll = daef._acts(config)
    h = _forward(config, xs, weights[:-1], biases[:-1])
    return f_ll.fn(weights[-1].transpose(-1, -2) @ h + biases[-1][..., None])


def _fit_core(config: daef.DAEFConfig, xs: torch.Tensor, keys: torch.Tensor, lam_hidden,
              lam_last, *, n_partitions: int = 1) -> daef.DAEFModel:
    """Alg. 1 for every tenant of ``xs`` [K, m0, n] at once (the reference
    vmaps ``daef._fit_core``)."""
    m0, n = xs.shape[1:]
    f_hl, f_ll = daef._acts(config)

    # ---- encoder: per-tenant Gram of the partitions, one batched eigh ----
    enc = dsvd.dsvd(daef._split(xs, n_partitions), rank=min(m0, n), method="gram")
    w_enc = enc.u[..., : config.latent_dim]
    h = f_hl.fn(w_enc.transpose(-1, -2) @ xs)  # [K, m1, n]

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---- decoder hidden layers: one draw, one stats launch, one solve ----
    sizes = config.layer_sizes
    for li in range(2, len(sizes) - 1):
        res = elm_ae.train_layer_batched(
            keys[:, li], h, sizes[li], lam_hidden, f_hl, init=config.init,
            aux_bias=config.aux_bias, backend=config.stats_backend,
            gram_solver=config.gram_solver,
        )
        weights.append(res.w)
        biases.append(res.b)
        knowledge.append(res.knowledge)
        h = res.h

    # ---- last layer: ROLANN against the inputs ----
    k_ll = rolann.compute_stats_batched(h, xs, f_ll, backend=config.stats_backend)
    w_ll, b_ll = rolann.solve(k_ll, lam_last, gram_solver=config.gram_solver,
                              shared_f=f_ll.name == "linear")
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(k_ll)
    recon = f_ll.fn(w_ll.transpose(-1, -2) @ h + b_ll[..., None])
    return daef.DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=torch.mean((recon - xs) ** 2, dim=1),
    )


def _fit_fleet(
    config: daef.DAEFConfig,
    xs,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    n_partitions: int = 1,
    device=None,
) -> DAEFFleet:
    """Train K independent DAEF models in one call.

    xs: [K, m0, n] — tenant k trains on xs[k]; moved to ``device``
    (``None``: the card).  seeds / lam_hidden / lam_last: scalar (shared) or
    [K] (per tenant); defaults come from ``config``.
    """
    dev = resolve_device(device)
    config = config.resolved()
    seeds, lam_hidden, lam_last = _prepare_fit(config, xs, seeds, lam_hidden, lam_last, dev)
    daef._require_ported(config)
    xs = as_tensor(xs, dev)
    model = _fit_core(config, xs, _tenant_keys(config, seeds), lam_hidden, lam_last,
                      n_partitions=n_partitions)
    return DAEFFleet(model=model, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last)


def fleet_fit(
    config: daef.DAEFConfig,
    xs,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    n_partitions: int = 1,
    device=None,
) -> DAEFFleet:
    """Train K independent DAEF models in one call (:func:`_fit_fleet`).  The
    reference's ``fleet_fit`` is a deprecation shim onto its engine; this one
    becomes that shim when the engine is ported (ROADMAP queue A item 9)."""
    if getattr(xs, "ndim", None) != 3:
        raise ValueError(f"fleet data must be [K, m0, n], got {_shape(xs)}")
    return _fit_fleet(config, xs, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last,
                      n_partitions=n_partitions, device=device)


@functools.lru_cache(maxsize=256)
def _fleet_mask(k: int, width: int, n_valid: int, device: torch.device) -> torch.Tensor:
    """One contiguous [k, width] mask per (tenants, width, valid prefix,
    device): every tenant's chunk has the same valid columns, and the B6
    kernel takes a mask row per tenant."""
    return daef._chunk_mask(width, n_valid, device).expand(k, width).contiguous()


def _fit_chunks(config: daef.DAEFConfig, passes, seeds_fn) -> DAEFFleet:
    """Alg. 1 as a fold for every tenant at once (``daef._fit_chunks`` over
    the tenant axis).  ``passes()`` returns a fresh iterator of ``(chunk
    [K, m0, width], mask [K, width], n_valid)`` on the device, one per pass;
    ``seeds_fn(k, dtype)`` gives the per-tenant (seeds, lam_hidden, lam_last)
    once the first pass has shown K."""
    f_hl, f_ll = daef._acts(config)
    sizes = config.layer_sizes
    m0 = sizes[0]
    backend = config.stats_backend

    # ---- pass 1: encoder Grams ----
    g = None
    n_total = 0
    for x, mask, n_valid in passes():
        if g is None:
            g = torch.zeros((x.shape[0], m0, m0), dtype=x.dtype, device=x.device)
        g.add_(dsvd.masked_gram(x, mask[:, None, :]))
        n_total += n_valid
    k = g.shape[0]
    seeds, lam_hidden, lam_last = seeds_fn(k, g.dtype)
    keys = _tenant_keys(config, seeds)
    enc = dsvd.truncate(dsvd.gram_to_factors(g), min(m0, n_total))
    w_enc = enc.u[..., : config.latent_dim]
    dtype, device = w_enc.dtype, w_enc.device

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---- passes 2..L-1: decoder layers, one B6 launch per chunk ----
    for li in range(2, len(sizes) - 1):
        w_c1, b_c1 = elm_ae.stage1_batched(keys[:, li], sizes[li - 1], sizes[li],
                                           config.init, dtype, device)
        stats = rolann.init_stats(sizes[li], sizes[li - 1], f_hl, dtype, device=device,
                                  tenants=k)
        for x, mask, _ in passes():
            h = _forward(config, x, weights, biases)
            elm_ae.accumulate_layer_stats_batched(stats, w_c1, b_c1, h, f_hl, weights=mask,
                                                  backend=backend)
        w_next, b_next = elm_ae.layer_from_knowledge_batched(
            stats, keys[:, li], sizes[li - 1], sizes[li], lam_hidden, f_hl,
            init=config.init, aux_bias=config.aux_bias, dtype=dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w_next)
        biases.append(b_next)
        knowledge.append(stats)

    # ---- pass L: last layer against the original inputs ----
    stats = rolann.init_stats(sizes[-2], m0, f_ll, dtype, device=device, tenants=k)
    for x, mask, _ in passes():
        h = _forward(config, x, weights, biases)
        rolann.accumulate_stats_batched(stats, h, x, f_ll, weights=mask, backend=backend)
    w_ll, b_ll = rolann.solve(stats, lam_last, gram_solver=config.gram_solver,
                              shared_f=f_ll.name == "linear")
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(stats)

    # ---- final pass: per-sample train errors ----
    errs = [torch.mean((_reconstruct(config, x, weights, biases) - x) ** 2, dim=1)[:, :n_valid]
            for x, _, n_valid in passes()]

    model = daef.DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=torch.cat(errs, dim=1),
    )
    return DAEFFleet(model=model, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last)


def _fit_fleet_chunked(
    config: daef.DAEFConfig,
    xs,
    *,
    chunk_samples: int,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    device=None,
) -> DAEFFleet:
    """Streaming fleet fit over ``xs`` [K, m0, n] on ``device`` (``None``: the
    card), cut into ``chunk_samples``-wide chunks (the ragged tail padded and
    masked): peak activation memory O(K·(m² + chunk)) instead of O(K·m·n).
    On the fused backend every hidden layer folds each chunk of every tenant
    in one launch of the B6 kernel."""
    dev = resolve_device(device)
    config = config.resolved()
    daef._require_gram(config, "chunked fleet fit")
    seeds, lam_hidden, lam_last = _prepare_fit(config, xs, seeds, lam_hidden, lam_last, dev)
    if not isinstance(chunk_samples, int) or chunk_samples < 1:
        raise ValueError(f"chunk_samples must be a positive int, got {chunk_samples!r}")
    xs = as_tensor(xs, dev)
    if xs.shape[2] == 0:
        raise ValueError("chunked fleet fit: xs has no samples")
    return _fit_chunks(config, _device_chunks(xs, chunk_samples),
                       lambda k, dtype: (seeds, lam_hidden, lam_last))


def _device_chunks(xs: torch.Tensor, chunk_samples: int):
    """``passes`` of :func:`_fit_chunks` over ``xs`` [K, m0, n] on its device:
    ``min(chunk_samples, n)``-wide chunks, the ragged tail zero-padded and
    masked.  One contiguous [n_chunks, K, m0, chunk] copy is made, so every
    chunk a kernel sees is a dense tensor."""
    k, m0, n = xs.shape
    chunk = min(chunk_samples, n)
    n_chunks = -(-n // chunk)
    xc = (F.pad(xs, (0, n_chunks * chunk - n)).reshape(k, m0, n_chunks, chunk)
          .permute(2, 0, 1, 3).contiguous())
    valid = [min(chunk, n - i * chunk) for i in range(n_chunks)]
    return lambda: ((xc[i], _fleet_mask(k, chunk, v, xs.device), v)
                    for i, v in enumerate(valid))


def _fit_fleet_stream(
    config: daef.DAEFConfig,
    batches,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    device=None,
    tenants: int | None = None,
) -> DAEFFleet:
    """Streaming fleet fit from a host chunk source of ``[K, m0, chunk]``
    arrays (an iterable, or a zero-arg callable yielding a fresh iterator
    per pass — one pass per layer plus the error pass).  Each chunk is
    uploaded to ``device`` (``None``: the card) on its own; only the last
    may be narrower (padded and masked).  ``tenants`` fixes the expected K.
    """
    dev = resolve_device(device)
    config = config.resolved()
    daef._require_gram(config, "streaming fleet fit")
    factory = daef._stream_chunk_source(batches)
    m0 = config.layer_sizes[0]

    def chunks():
        k = tenants
        for x, _, n_valid in daef._iter_padded_chunks(factory, m0, dev, ndim=3,
                                                      what="fleet fit_stream"):
            if k is None:
                k = x.shape[0]
            elif x.shape[0] != k:
                raise ValueError(
                    f"fleet fit_stream: chunks carry {x.shape[0]} tenants "
                    f"but {k} were expected"
                    + ("" if tenants is not None else " (tenant count "
                       "changed mid-stream)")
                )
            yield x, _fleet_mask(k, x.shape[-1], n_valid, dev), n_valid

    def seeds_fn(k, dtype):
        return (_per_tenant(seeds, config.seed, k, torch.int32, dev),
                _per_tenant(lam_hidden, config.lam_hidden, k, dtype, dev),
                _per_tenant(lam_last, config.lam_last, k, dtype, dev))

    return _fit_chunks(config, chunks, seeds_fn)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _fleet_data(fleet: DAEFFleet, xs, device) -> torch.Tensor:
    return as_tensor(xs, daef._model_device(fleet.model, device), fleet.model.weights[0].dtype)


def fleet_predict(config: daef.DAEFConfig, fleet: DAEFFleet, xs, *, device=None) -> torch.Tensor:
    """Reconstruct xs [K, m0, n] — tenant k's model reconstructs xs[k]."""
    xs = _fleet_data(fleet, xs, device)
    return _reconstruct(config, xs, fleet.model.weights, fleet.model.biases)


def fleet_scores(
    config: daef.DAEFConfig,
    fleet: DAEFFleet,
    xs,
    n_valid=None,
    *,
    device=None,
) -> torch.Tensor:
    """Per-sample anomaly scores [K, n] in one call.

    ``n_valid`` ([K] ints) masks a padded serving batch: scores of padding
    columns (j >= n_valid[k]) come back as NaN so downstream thresholding
    can never mistake padding for a real sample.
    """
    xs = _fleet_data(fleet, xs, device)
    recon = _reconstruct(config, xs, fleet.model.weights, fleet.model.biases)
    errs = torch.mean((recon - xs) ** 2, dim=1)
    if n_valid is None:
        return errs
    valid = torch.as_tensor(n_valid, device=errs.device)
    mask = torch.arange(xs.shape[-1], device=errs.device)[None, :] < valid[:, None]
    return torch.where(mask, errs, torch.nan)


def fleet_thresholds(fleet: DAEFFleet, rule: str = "extreme_iqr") -> torch.Tensor:
    """Per-tenant anomaly thresholds [K] from each model's train errors, on
    the fleet's device (one NaN-aware quantile call for all tenants)."""
    errs = fleet.model.train_errors
    return anomaly.threshold(errs, rule, device=errs.device)


def fleet_classify(scores, mus, *, device=None) -> torch.Tensor:
    """Flag anomalies per tenant: scores [K, n] vs thresholds [K] -> int32
    [K, n].  NaN scores (serving-batch padding) classify as 0 (normal)."""
    dev = resolve_device(device)
    scores = as_tensor(scores, dev)
    mus = as_tensor(mus, dev, scores.dtype)
    return (scores > mus[:, None]).to(torch.int32)


# ---------------------------------------------------------------------------
# Federated aggregation
# ---------------------------------------------------------------------------

def _check_merge_compat(a: DAEFFleet, b: DAEFFleet, op: str) -> None:
    """Merge-compatibility validation shared by :func:`fleet_merge` and
    (later) the engine's loop-mode merge: equal sizes, shared per-tenant
    seeds (the paper's stage-1 randomness requirement) and matching
    lambdas.  ``op`` names the caller, as in the reference."""
    del op  # the reference uses it only for its tracer guard
    if a.size != b.size:
        raise ValueError(f"fleet sizes differ: {a.size} != {b.size}")
    if not torch.equal(a.seeds.cpu(), b.seeds.cpu()):
        raise ValueError(
            "cannot merge fleets trained with different per-tenant seeds: "
            "decoder knowledge is only mergeable under shared stage-1 "
            "randomness (retrain one side with matching seeds)"
        )
    if not (torch.allclose(a.lam_hidden.cpu(), b.lam_hidden.cpu())
            and torch.allclose(a.lam_last.cpu(), b.lam_last.cpu())):
        raise ValueError("cannot merge fleets with different per-tenant lambdas")


def fleet_merge(config: daef.DAEFConfig, a: DAEFFleet, b: DAEFFleet) -> DAEFFleet:
    """Pairwise-federated aggregation: tenant k of ``a`` merges with tenant k
    of ``b`` (both must have been trained with the same per-tenant seed —
    the paper's shared-randomness requirement)."""
    _check_merge_compat(a, b, "fleet_merge")
    return fleet_merge_unchecked(config, a, b)


def fleet_merge_unchecked(config: daef.DAEFConfig, a: DAEFFleet, b: DAEFFleet) -> DAEFFleet:
    """:func:`fleet_merge` without the seed and lambda validation (the
    caller asserts shared stage-1 randomness): every tenant's encoder
    factors merge by one batched SVD, its (G, M) by sums, and one batched
    solve per layer re-solves the weights."""
    model = daef._merge_core(config, a.model, b.model, _tenant_keys(config, a.seeds),
                             a.lam_hidden, a.lam_last)
    return DAEFFleet(model=model, seeds=a.seeds, lam_hidden=a.lam_hidden,
                     lam_last=a.lam_last)


def fleet_partial_fit(config: daef.DAEFConfig, fleet: DAEFFleet, xs_new, *,
                      device=None) -> DAEFFleet:
    """Incremental learning for every tenant at once: fit the new blocks
    xs_new [K, m0, n] on the fleet's device (same seeds, so the stage-1
    randomness lines up) and merge."""
    update = _fit_fleet(
        config, xs_new, seeds=fleet.seeds, lam_hidden=fleet.lam_hidden,
        lam_last=fleet.lam_last, device=daef._model_device(fleet.model, device),
    )
    return fleet_merge(config, fleet, update)


def fleet_merge_pairwise(config: daef.DAEFConfig, fleet: DAEFFleet) -> DAEFFleet:
    """Tree-reduction step: merge tenants (0,1), (2,3), ... into a fleet of
    K//2 models.  Adjacent tenants must share a seed (they are federated
    nodes of the same logical model)."""
    if fleet.size % 2:
        raise ValueError(f"need an even fleet size, got {fleet.size}")
    even = _tree_map(lambda leaf: leaf[0::2].contiguous(), fleet)
    odd = _tree_map(lambda leaf: leaf[1::2].contiguous(), fleet)
    return fleet_merge(config, even, odd)


# ---------------------------------------------------------------------------
# Interop with single-model daef
# ---------------------------------------------------------------------------

def fleet_from_models(
    config: daef.DAEFConfig,
    models: list[daef.DAEFModel],
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
) -> DAEFFleet:
    """Stack individually trained ``daef.fit`` models into a fleet, on their
    device."""
    if not models:
        raise ValueError("empty model list")
    k = len(models)
    per_model = [_tree_leaves(m) for m in models]
    stacked = [torch.stack(leaves) for leaves in zip(*per_model, strict=True)]
    it = iter(stacked)
    model = _tree_map(lambda _: next(it), models[0])
    device = model.weights[0].device
    return DAEFFleet(
        model=model,
        seeds=_per_tenant(seeds, config.seed, k, torch.int32, device),
        lam_hidden=_per_tenant(lam_hidden, config.lam_hidden, k, torch.float32, device),
        lam_last=_per_tenant(lam_last, config.lam_last, k, torch.float32, device),
    )


def get_model(fleet: DAEFFleet, i: int) -> daef.DAEFModel:
    """Extract tenant ``i`` as a plain single-model ``daef.DAEFModel``."""
    return _tree_map(lambda leaf: leaf[i], fleet.model)
