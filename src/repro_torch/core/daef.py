"""DAEF — Deep Autoencoder for Federated learning (paper §4, Algorithm 1).

Counterpart of ``repro/core/daef.py``: the one-shot fit, the streaming fits
``fit_chunked`` and ``fit_stream``, ``predict`` and ``reconstruction_error``.
An asymmetric deep autoencoder:

  * encoder: ONE layer whose weights are the truncated left singular vectors
    of the data matrix, from a distributed SVD — no bias;
  * decoder: hidden layers, each trained in closed form by the auxiliary
    ELM-AE + ROLANN procedure (``elm_ae.train_layer``);
  * last layer: ROLANN directly against the inputs, linear activation.

Everything is closed-form — no gradients, no epochs.  Data is
``[features m0, samples n]``.

``method`` picks the knowledge: "gram" (the fast path: Gram sums, the
encoder by eigh of the summed Grams) or "svd" (the paper's: factors from
SVDs, the encoder by local SVDs merged by Eq. 2).  The streaming fits take
"gram" only, as the reference's do.

Federated aggregation (paper §4.3): :func:`merge_models` merges two
models' exchanged knowledge (encoder factors by Eq. 2, decoder (G, M) by
sum or factors by Eq. 8-9) and re-solves the weights; :func:`partial_fit`
absorbs a new block.

Entry points take ``device=``: ``None`` means the card (see
:mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import activations, dsvd, elm_ae, rolann, stats_backend, threefry
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class DAEFConfig:
    """Hyperparameters (paper Alg. 1 inputs + Appendix Table 5 naming); the
    reference's fields, defaults and validation.

    layer_sizes: the paper's ``a`` — [m0, m1, ..., m0]; m1 is the latent
        dimension, and the first and last entries equal the input dimension.
    """

    layer_sizes: tuple[int, ...]
    lam_hidden: float = 0.01          # lambda_HL
    lam_last: float = 0.1             # lambda_LL
    act_hidden: str = "logsig"        # f_HL
    act_last: str = "linear"          # f_LL
    init: str = "xavier"              # stage-1 initializer (xavier|random|orthogonal)
    aux_bias: str = "zero"            # decoder bias scheme (see elm_ae)
    method: str = "gram"              # "gram" fast path | "svd" paper-faithful
    seed: int = 0                     # shared randomness across federated nodes
    # Gram-stats producer: "einsum" | "fused" | "auto"; None defers to
    # $REPRO_STATS_BACKEND, then "auto".
    stats_backend: str | None = None
    gram_solver: str = "chol"         # "chol" | "eigh" | "auto" (see rolann.solve)

    def __post_init__(self):
        if len(self.layer_sizes) < 3:
            raise ValueError("DAEF needs at least [m0, m1, m0]")
        if self.layer_sizes[0] != self.layer_sizes[-1]:
            raise ValueError(
                f"autoencoder must reconstruct its input: "
                f"{self.layer_sizes[0]} != {self.layer_sizes[-1]}"
            )
        if self.stats_backend is not None:
            stats_backend.resolve(self.stats_backend)  # raises on unknown names
        if self.gram_solver not in rolann.GRAM_SOLVERS:
            raise ValueError(
                f"unknown gram_solver {self.gram_solver!r}: choose from "
                f"{rolann.GRAM_SOLVERS}"
            )

    def resolved(self, device=None) -> DAEFConfig:
        """This config with ``stats_backend`` made concrete (env resolved;
        ``"auto"`` for the platform of ``device``, where the fit runs)."""
        concrete = stats_backend.resolve(self.stats_backend, device)
        if concrete == self.stats_backend:
            return self
        return dataclasses.replace(self, stats_backend=concrete)

    @property
    def latent_dim(self) -> int:
        return self.layer_sizes[1]

    @property
    def n_decoder_hidden(self) -> int:
        # layers strictly between the latent layer and the output layer
        return len(self.layer_sizes) - 3

    def layer_keys(self) -> torch.Tensor:
        """Deterministic per-layer keys [n_layers, 2] — the shared randomness
        every federated node derives from the agreed seed, equal to the
        reference's ``jax.random`` keys."""
        return layer_keys_from_seed(self.seed, len(self.layer_sizes))


def layer_keys_from_seed(seed, n_layers: int) -> torch.Tensor:
    """Stacked per-layer keys [n_layers, 2] (int64 holding uint32 words) of
    an int seed, or [K, n_layers, 2] of a fleet's int32 seeds [K] (the keys
    ``jax.vmap`` of the reference gives)."""
    if isinstance(seed, torch.Tensor) and seed.ndim:
        root = threefry.prng_keys(seed.cpu())
    else:
        root = threefry.PRNGKey(seed)
    return threefry.split(root, max(1, n_layers))


class DAEFModel(NamedTuple):
    """Trained model M (Alg. 1 output)."""

    weights: tuple[torch.Tensor, ...]   # W1 (encoder), W2..WL (decoder)
    biases: tuple[torch.Tensor, ...]    # decoder biases (len = len(weights)-1)
    encoder_factors: dsvd.SvdFactors    # untruncated U1, S1 (mergeable)
    layer_knowledge: tuple              # ROLANN knowledge per decoder layer
    train_errors: torch.Tensor          # per-sample reconstruction MSE on train


def _acts(config: DAEFConfig):
    f_hl = activations.get(config.act_hidden, invertible_required=True)
    f_ll = activations.get(config.act_last, invertible_required=True)
    return f_hl, f_ll


def fit(
    config: DAEFConfig, x, *, n_partitions: int = 1, device=None
) -> DAEFModel:
    """Alg. 1 — non-iterative DAEF training on one device.

    ``n_partitions`` splits the samples to exercise the distributed-SVD
    merge as the paper describes (identical to 1 partition up to numerics).
    ``x`` [m0, n] is moved to ``device`` (``None``: the card).
    """
    x = as_tensor(x, resolve_device(device))
    m0 = x.shape[0]
    if m0 != config.layer_sizes[0]:
        raise ValueError(f"input dim {m0} != layer_sizes[0] {config.layer_sizes[0]}")
    config = config.resolved(x.device)
    return _fit_core(
        config, x, config.layer_keys(), config.lam_hidden, config.lam_last,
        n_partitions=n_partitions,
    )


def _fit_core(
    config: DAEFConfig,
    x: torch.Tensor,
    keys: torch.Tensor,
    lam_hidden: float,
    lam_last: float,
    *,
    n_partitions: int = 1,
) -> DAEFModel:
    """Alg. 1 body on the device of ``x``."""
    m0, n = x.shape
    f_hl, f_ll = _acts(config)

    # ---- encoder: distributed truncated SVD (lines 5-12) ----
    parts = _split(x, n_partitions)
    enc = dsvd.dsvd(parts, rank=min(m0, n), method=_dsvd_method(config))
    w_enc = enc.u[:, : config.latent_dim]
    h = f_hl.fn(w_enc.T @ x)  # [m1, n]

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---- decoder hidden layers (lines 13-19) ----
    sizes = config.layer_sizes
    for li in range(2, len(sizes) - 1):
        res = elm_ae.train_layer(
            keys[li],
            h,
            sizes[li],
            lam_hidden,
            f_hl,
            init=config.init,
            aux_bias=config.aux_bias,
            method=config.method,
            backend=config.stats_backend,
            gram_solver=config.gram_solver,
        )
        weights.append(res.w)
        biases.append(res.b)
        knowledge.append(res.knowledge)
        h = res.h

    # ---- last layer: supervised ROLANN to reconstruct X (lines 20-25) ----
    w_ll, b_ll, k_ll = rolann.fit(
        h, x, f_ll, lam_last, method=config.method,
        backend=config.stats_backend, gram_solver=config.gram_solver,
    )
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(k_ll)
    recon = f_ll.fn(w_ll.T @ h + b_ll[:, None])
    train_errors = torch.mean((recon - x) ** 2, dim=0)

    return DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=train_errors,
    )


# ---------------------------------------------------------------------------
# Streaming / chunked training (bounded-memory Alg. 1)
#
# The paper's sufficient statistics are additive over sample blocks (Eq. 6-9),
# so the whole fit is a FOLD: pass 1 accumulates the encoder Gram chunk by
# chunk, passes 2..L recompute the chunk activations on the fly and fold each
# decoder layer's (G, M) in place, and a final pass scores the train errors.
# Peak device memory is O(m^2 + chunk) for a host source; the result is the
# one-shot gram-method fit up to the order of float sums.
#
# Both drivers feed one loop over padded, masked chunks (`_fit_chunks`):
#   * `fit_chunked` — x on the device, cut into `chunk_samples`-wide chunks;
#   * `fit_stream`  — a host chunk source, one chunk uploaded at a time.
# The reference's `lax.scan` and donated jitted steps become Python loops
# whose steps update the running statistics in place.
# ---------------------------------------------------------------------------

def _require_gram(config: DAEFConfig, what: str) -> None:
    if config.method != "gram":
        raise ValueError(
            f"{what} accumulates Gram sufficient statistics chunk by chunk "
            "(method='gram'); method='svd' factors have no additive chunk "
            "form — switch the config to method='gram'"
        )


def _stream_forward(config: DAEFConfig, x: torch.Tensor, weights, biases) -> torch.Tensor:
    """Forward one chunk through the encoder + the solved decoder layers so
    far (all hidden activations) — the recompute-on-the-fly of each pass."""
    f_hl, _ = _acts(config)
    h = f_hl.fn(weights[0].T @ x)
    for w, b in zip(weights[1:], biases, strict=True):
        h = f_hl.fn(w.T @ h + b[:, None])
    return h


def _stream_layer_step(config: DAEFConfig, stats, params, x, mask):
    weights, biases, w_c1, b_c1 = params
    f_hl, _ = _acts(config)
    h = _stream_forward(config, x, weights, biases)
    return elm_ae.accumulate_layer_stats(
        stats, w_c1, b_c1, h, f_hl, weights=mask, backend=config.stats_backend
    )


def _stream_last_step(config: DAEFConfig, stats, params, x, mask):
    weights, biases = params
    _, f_ll = _acts(config)
    h = _stream_forward(config, x, weights, biases)
    return rolann.accumulate_stats(
        stats, h, x, f_ll, weights=mask, backend=config.stats_backend
    )


def _errors_chunk(config: DAEFConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Per-sample reconstruction MSE of one chunk under solved weights."""
    weights, biases = params
    _, f_ll = _acts(config)
    h = _stream_forward(config, x, weights[:-1], biases[:-1])
    recon = f_ll.fn(weights[-1].T @ h + biases[-1][:, None])
    return torch.mean((recon - x) ** 2, dim=0)


def _fit_chunks(config: DAEFConfig, passes) -> DAEFModel:
    """Alg. 1 as a fold.  ``passes()`` returns a fresh iterator of
    ``(chunk [m0, width], mask [width], n_valid)`` on the device, one per
    pass: the encoder, each decoder layer, the last layer, the errors."""
    f_hl, f_ll = _acts(config)
    sizes = config.layer_sizes
    m0 = sizes[0]
    keys = config.layer_keys()

    # ---- pass 1: encoder Gram ----
    g = None
    n_total = 0
    for x, mask, n_valid in passes():
        if g is None:
            g = torch.zeros((m0, m0), dtype=x.dtype, device=x.device)
        g.add_(dsvd.masked_gram(x, mask))
        n_total += n_valid
    enc = dsvd.truncate(dsvd.gram_to_factors(g), min(m0, n_total))
    w_enc = enc.u[:, : config.latent_dim]
    dtype, device = w_enc.dtype, w_enc.device

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---- passes 2..L-1: decoder layers ----
    for li in range(2, len(sizes) - 1):
        w_c1, b_c1 = elm_ae.stage1(keys[li], sizes[li - 1], sizes[li], config.init,
                                   dtype, device)
        params = (tuple(weights), tuple(biases), w_c1, b_c1)
        stats = rolann.init_stats(sizes[li], sizes[li - 1], f_hl, dtype, device=device)
        for x, mask, _ in passes():
            _stream_layer_step(config, stats, params, x, mask)
        w_next, b_next = elm_ae.layer_from_knowledge(
            stats, keys[li], sizes[li - 1], sizes[li], config.lam_hidden, f_hl,
            init=config.init, aux_bias=config.aux_bias, dtype=dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w_next)
        biases.append(b_next)
        knowledge.append(stats)

    # ---- pass L: last layer against the original inputs ----
    params = (tuple(weights), tuple(biases))
    stats = rolann.init_stats(sizes[-2], m0, f_ll, dtype, device=device)
    for x, mask, _ in passes():
        _stream_last_step(config, stats, params, x, mask)
    w_ll, b_ll = rolann.solve(stats, config.lam_last, gram_solver=config.gram_solver)
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(stats)

    # ---- final pass: per-sample train errors ----
    params = (tuple(weights), tuple(biases))
    errs = [_errors_chunk(config, params, x)[:n_valid] for x, _, n_valid in passes()]

    return DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=torch.cat(errs),
    )


def fit_chunked(
    config: DAEFConfig, x, *, chunk_samples: int, device=None
) -> DAEFModel:
    """Alg. 1 with bounded activation memory: :func:`fit` as a fold over
    ``chunk_samples``-wide sample chunks of ``x`` [m0, n], on ``device``
    (``None``: the card).

    Matches ``fit(config, x)`` (gram method) within accumulation-order float
    error for every chunk size, including widths that do not divide n: the
    ragged tail is padded to the chunk width and masked, so every chunk has
    one shape.  ``chunk_samples > n`` makes one chunk of width n.
    """
    x = as_tensor(x, resolve_device(device))
    m0, n = x.shape
    if m0 != config.layer_sizes[0]:
        raise ValueError(f"input dim {m0} != layer_sizes[0] {config.layer_sizes[0]}")
    if not isinstance(chunk_samples, int) or chunk_samples < 1:
        raise ValueError(f"chunk_samples must be a positive int, got {chunk_samples!r}")
    config = config.resolved(x.device)
    _require_gram(config, "fit_chunked")
    if n == 0:
        raise ValueError("fit_chunked: x has no samples")
    return _fit_chunks(config, _device_chunks(x, chunk_samples))


def _device_chunks(x: torch.Tensor, chunk_samples: int):
    """``passes`` of :func:`_fit_chunks` over ``x`` [m0, n] on its device:
    ``min(chunk_samples, n)``-wide chunks, the ragged tail zero-padded and
    masked.  One contiguous [n_chunks, m0, chunk] copy is made, so every
    chunk a kernel sees is a dense tensor."""
    m0, n = x.shape
    chunk = min(chunk_samples, n)
    n_chunks = -(-n // chunk)
    xc = (F.pad(x, (0, n_chunks * chunk - n)).reshape(m0, n_chunks, chunk)
          .permute(1, 0, 2).contiguous())
    valid = [min(chunk, n - i * chunk) for i in range(n_chunks)]
    return lambda: ((xc[i], _chunk_mask(chunk, v, x.device), v) for i, v in enumerate(valid))


def _stream_chunk_source(batches):
    """Normalize a chunk source into a zero-arg factory of fresh iterators.

    Accepts a zero-arg callable (called once per pass — true streaming, e.g.
    re-opening a file reader), or any iterable (materialized ONCE into a host
    list of chunk references; the chunks themselves are not copied).  The fit
    makes one pass per layer, so one-shot generators are snapshotted.
    """
    if callable(batches):
        return batches
    chunks = list(batches)
    return lambda: iter(chunks)


@functools.lru_cache(maxsize=256)
def _chunk_mask(width: int, n_valid: int, device: torch.device) -> torch.Tensor:
    """One mask per (width, valid prefix, device) — every full chunk of a
    fit reuses a single device buffer instead of making one per step."""
    return (torch.arange(width, device=device) < n_valid).to(torch.float32)


def _iter_padded_chunks(factory, m0: int, device: torch.device, *, ndim: int = 2,
                        what: str = "fit_stream", place=None):
    """Yield (chunk on ``device``, mask, n_valid) with the ragged tail padded
    to the fixed chunk width, one host chunk uploaded at a time.  Only the
    LAST chunk may be narrower; mid-stream width changes are an error.
    A fleet's chunks are [K, m0, width] (``ndim=3``); ``place`` maps each
    checked chunk to the part that is uploaded (a mesh rank's tenants)."""
    it = iter(factory())
    prev = next(it, None)
    if prev is None:
        raise ValueError(f"{what}: empty chunk stream")
    width = None
    while prev is not None:
        cur = next(it, None)
        x = prev if isinstance(prev, torch.Tensor) else np.asarray(prev)
        if x.ndim != ndim or x.shape[-2] != m0:
            raise ValueError(
                f"{what}: chunk shape {tuple(x.shape)} does not match the expected "
                f"[{'K, ' if ndim == 3 else ''}{m0}, chunk_samples] layout"
            )
        c = x.shape[-1]
        if width is None:
            width = c
        if c != width:
            if cur is not None or c > width:
                raise ValueError(
                    f"{what}: chunk widths must be fixed ({width}); got a "
                    f"{'mid-stream' if cur is not None else 'wider final'} "
                    f"chunk of width {c} — re-chunk the source (only the "
                    "last chunk may be narrower)"
                )
        chunk = as_tensor(x if place is None else place(x), device)
        if c != width:
            chunk = F.pad(chunk, (0, width - c))
        yield chunk.contiguous(), _chunk_mask(width, c, device), c
        prev = cur


def fit_stream(config: DAEFConfig, batches, *, device=None) -> DAEFModel:
    """Alg. 1 over data that never fits on the device at once.

    ``batches`` is a host chunk source — an iterable of fixed-shape
    ``[m0, chunk_samples]`` arrays or tensors (only the last may be
    narrower; it is padded and masked), or a zero-arg callable returning a
    fresh iterator per pass (true streaming from disk; the fit makes one
    pass per layer plus an error-scoring pass).  Each chunk is uploaded to
    ``device`` (``None``: the card) on its own, and the running statistics
    are updated in place, so device memory stays the O(m^2) statistics plus
    one chunk (and the [n] train errors).

    Numerically matches ``fit(config, concatenate(batches))`` (gram method)
    within accumulation-order float error.
    """
    dev = resolve_device(device)
    config = config.resolved(dev)
    _require_gram(config, "fit_stream")
    factory = _stream_chunk_source(batches)
    m0 = config.layer_sizes[0]
    return _fit_chunks(config, lambda: _iter_padded_chunks(factory, m0, dev))


def _model_device(model: DAEFModel, device) -> torch.device:
    dev = resolve_device(device)
    have = model.weights[0].device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(
            f"model lies on {have} but device={dev} was asked for; move the "
            "model (interop.model_from_numpy) or pass its device"
        )
    return have


def predict(config: DAEFConfig, model: DAEFModel, x, *, device=None) -> torch.Tensor:
    """Alg. 3 — reconstruct test samples x [m0, n]."""
    x = as_tensor(x, _model_device(model, device), model.weights[0].dtype)
    f_hl, f_ll = _acts(config)
    h = f_hl.fn(model.weights[0].T @ x)  # encoder: no bias
    for w, b in zip(model.weights[1:-1], model.biases[:-1], strict=True):
        h = f_hl.fn(w.T @ h + b[:, None])
    w, b = model.weights[-1], model.biases[-1]
    return f_ll.fn(w.T @ h + b[:, None])


def reconstruction_error(
    config: DAEFConfig, model: DAEFModel, x, *, device=None
) -> torch.Tensor:
    """Per-sample MSE reconstruction error (the anomaly score)."""
    x = as_tensor(x, _model_device(model, device), model.weights[0].dtype)
    recon = predict(config, model, x, device=x.device)
    return torch.mean((recon - x) ** 2, dim=0)


# ---------------------------------------------------------------------------
# Federated aggregation / incremental learning
# ---------------------------------------------------------------------------

def merge_models(config: DAEFConfig, a: DAEFModel, b: DAEFModel, x_stats=None) -> DAEFModel:
    """Aggregate two DAEF models trained on different partitions (paper §4.3).

    The exchanged state is what the paper sends through the broker: the
    encoder's (U, S) factors and each decoder layer's ROLANN knowledge.
    Weights are re-solved from the merged knowledge.  As in the paper, each
    node computed its decoder statistics against its own encoder, so after
    the encoders merge the decoder statistics approximate the centralized
    solution.  ``x_stats`` is accepted and ignored, as in the reference.
    """
    return _merge_core(config, a, b, config.layer_keys(), config.lam_hidden,
                       config.lam_last)


def _merge_core(config: DAEFConfig, a: DAEFModel, b: DAEFModel, keys, lam_hidden,
                lam_last) -> DAEFModel:
    """Merge body: knowledge merge, then one re-solve."""
    enc, knowledge, errors = merge_knowledge(config, a, b)
    return _model_from_knowledge(config, enc, knowledge, keys, lam_hidden, lam_last,
                                 errors)


def merge_knowledge(
    config: DAEFConfig, a: DAEFModel, b: DAEFModel
) -> tuple[dsvd.SvdFactors, tuple, torch.Tensor]:
    """Merge only the exchanged federated state of two models: encoder
    factors (Eq. 2), per-layer ROLANN knowledge ((G, M) sums, or factors by
    Eq. 8-9) and the train-error pool.  The weights are re-solved separately
    (:func:`_model_from_knowledge`), so a tree reduction pays one solve at
    its root.  Leaves may carry a leading tenant axis (a fleet's): the
    factors merge per tenant and the train errors pool along the sample
    axis."""
    merge = rolann.merge_stats if config.method == "gram" else rolann.merge_factors
    enc = dsvd.merge_pair(a.encoder_factors, b.encoder_factors)
    knowledge = tuple(
        merge(ka, kb) for ka, kb in zip(a.layer_knowledge, b.layer_knowledge, strict=True)
    )
    errors = torch.cat([a.train_errors, b.train_errors], dim=-1)
    return enc, knowledge, errors


def _model_from_knowledge(
    config: DAEFConfig,
    enc: dsvd.SvdFactors,
    knowledge,
    keys: torch.Tensor,
    lam_hidden,
    lam_last,
    train_errors: torch.Tensor,
) -> DAEFModel:
    """Re-solve every layer's weights from (merged) federated knowledge.

    A fleet passes leaves with a leading tenant axis [K], keys [K, L, 2] and
    per-tenant lambdas [K]; one solve per layer covers every tenant."""
    f_hl, f_ll = _acts(config)
    sizes = config.layer_sizes
    w_enc = enc.u[..., : config.latent_dim]
    weights = [w_enc]
    biases: list[torch.Tensor] = []
    batched = keys.ndim == 3

    for li in range(2, len(sizes) - 1):
        layer_from = elm_ae.layer_from_knowledge_batched if batched else elm_ae.layer_from_knowledge
        w, bias = layer_from(
            knowledge[li - 2], keys[..., li, :], sizes[li - 1], sizes[li], lam_hidden, f_hl,
            init=config.init, aux_bias=config.aux_bias, dtype=w_enc.dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w)
        biases.append(bias)

    w_ll, b_ll = rolann.solve(knowledge[-1], lam_last, gram_solver=config.gram_solver,
                              shared_f=f_ll.name == "linear")
    weights.append(w_ll)
    biases.append(b_ll)
    return DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=train_errors,
    )


def partial_fit(config: DAEFConfig, model: DAEFModel, x_new, *, device=None) -> DAEFModel:
    """Incremental learning: absorb a new data block ``x_new`` [m0, n] into a
    trained model (fit the block with the same seed, then merge).  The block
    goes to the model's device."""
    update = fit(config, x_new, device=_model_device(model, device))
    return merge_models(config, model, update)


def _split(x: torch.Tensor, p: int) -> list[torch.Tensor]:
    """``p`` contiguous partitions of the sample (last) axis of ``x``."""
    if p <= 1:
        return [x]
    n = x.shape[-1]
    bounds = [round(i * n / p) for i in range(p + 1)]
    return [x[..., bounds[i] : bounds[i + 1]] for i in range(p)]


def _dsvd_method(config: DAEFConfig) -> str:
    return "gram" if config.method == "gram" else "svd"
