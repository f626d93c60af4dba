"""DAEF — Deep Autoencoder for Federated learning (paper §4, Algorithm 1).

Counterpart of ``repro/core/daef.py``: the one-shot fit, ``predict`` and
``reconstruction_error``.  An asymmetric deep autoencoder:

  * encoder: ONE layer whose weights are the truncated left singular vectors
    of the data matrix, from a distributed SVD (gram route) — no bias;
  * decoder: hidden layers, each trained in closed form by the auxiliary
    ELM-AE + ROLANN procedure (``elm_ae.train_layer``);
  * last layer: ROLANN directly against the inputs, linear activation.

Everything is closed-form — no gradients, no epochs.  Data is
``[features m0, samples n]``.

Entry points take ``device=``: ``None`` means the card (see
:mod:`repro_torch.device`).  The streaming fits, merges and
``partial_fit`` wait for ROADMAP queue A items 5 and 7.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

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

    def resolved(self) -> DAEFConfig:
        """This config with ``stats_backend`` made concrete (env resolved)."""
        concrete = stats_backend.resolve(self.stats_backend)
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


def layer_keys_from_seed(seed: int, n_layers: int) -> torch.Tensor:
    """Stacked per-layer keys [n_layers, 2] (int64 holding uint32 words)."""
    return threefry.split(threefry.PRNGKey(seed), max(1, n_layers))


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
    if config.method != "gram":
        raise NotImplementedError(
            f"method={config.method!r} is not ported yet (ROADMAP queue A "
            "items 3-5 port the svd route); use method='gram'"
        )
    config = config.resolved()
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
    enc = dsvd.dsvd(parts, rank=min(m0, n), method="gram")
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


def _split(x: torch.Tensor, p: int) -> list[torch.Tensor]:
    if p <= 1:
        return [x]
    n = x.shape[1]
    bounds = [round(i * n / p) for i in range(p + 1)]
    return [x[:, bounds[i] : bounds[i + 1]] for i in range(p)]
