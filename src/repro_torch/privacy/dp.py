# repro-lint: privacy
"""DP release of the DAEF sufficient statistics (Gaussian mechanism)
(counterpart of ``repro/privacy/dp.py``).

`fit_dp` is the private counterpart of `daef.fit` for ``method="gram"``:
every statistics block that LEAVES the site — encoder Gram, each decoder
layer's (G, M), the last layer's (G, M), and the train-error pool — is
perturbed ONCE, at release time, with Gaussian noise calibrated by the
analytic Gaussian mechanism (Balle & Wang 2018).  The model itself is
re-solved FROM the noised blocks, so everything downstream (weights,
merges, thresholds) is post-processing and spends no extra budget.

Adaptive per-block composition
------------------------------
DAEF's layers are trained in sequence and each layer's statistics depend
on the privatized weights of the previous layers.  The release is
therefore a B-fold ADAPTIVE composition of Gaussian mechanisms: block i
sees the data and the noised outputs of blocks < i.  The spec's
(epsilon, delta) is split across the B blocks (basic composition holds
under adaptivity) in proportion to sensitivity^(2/3), each share
calibrated to one sigma per unit sensitivity and scaled by the block's L2
sensitivity.

Sensitivity bounds (add/remove-one adjacency, input columns clipped to
L2 <= C by `clip_columns`):

* encoder Gram ``sum_i x_i x_i^T``:  ``Delta = C^2``.
* hidden decoder layer li (logsig, per-output G):  ROLANN inputs are the
  augmented auxiliary activations ``xa`` in (0, 1]^{m+1} with
  ``m = sizes[li]``, so ``||xa||^2 <= m + 1``; the per-output weight
  ``fp_j^2 = (d_j(1-d_j))^2 <= 1/16``; stacking ``sizes[li-1]`` outputs:
  ``Delta_G <= (m+1)/16 * sqrt(sizes[li-1])``.  The M vector weight is
  ``|fp_j^2 * logit(d_j)| <= FD_BOUND`` (numeric sup, ~0.0387), giving
  ``Delta_M <= sqrt(m+1) * FD_BOUND * sqrt(sizes[li-1])``.
* last layer (linear, shared G): ``xa`` are augmented logsig activations
  of width ``sizes[-2]+1``: ``Delta_G = sizes[-2]+1``; targets are the
  clipped inputs, so ``Delta_M = sqrt(sizes[-2]+1) * C``.
* train errors: released as a noised fixed-bin histogram (one sample
  moves one count: ``Delta = 1``), then deterministically resampled into
  a fixed-size synthetic pool — the pool shape leaks nothing about n.

Each (G, M) block is noised jointly with ``Delta = sqrt(Dg^2 + Dm^2)``.
Gram blocks get SYMMETRIC noise (iid upper triangle, mirrored) and are
eigenvalue-clipped back to PSD so the downstream Cholesky solve stays
well-posed — both post-processing.

All randomness comes from the caller-provided key, drawn on the host by
the port's threefry (`core.threefry`): the same key gives the reference's
noise bit for bit, which then moves to the statistics' device.  On the
fused backend each hidden layer's statistics fold is the B3 kernel, one
launch per layer and sample chunk.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import activations, dsvd, elm_ae, rolann, threefry
from repro_torch.device import as_tensor, resolve_device
from repro_torch.privacy.spec import PrivacyError, PrivacySpec

#: sup over d in (0,1) of (d(1-d))^2 * |logit(d)| — the per-entry bound on
#: ROLANN's M-vector weight under logsig targets.  The expression vanishes
#: at both endpoints and has one interior maximum (~0.0387 near d ~ 0.26);
#: a dense grid pins it to ~1e-9, and we round UP so the bound stays valid.
_fd_grid = np.linspace(1e-6, 1.0 - 1e-6, 200_001)
FD_BOUND = float(
    np.max((_fd_grid * (1.0 - _fd_grid)) ** 2
           * np.abs(np.log(_fd_grid) - np.log1p(-_fd_grid)))
) + 1e-6
del _fd_grid

#: Train-error release: histogram bins on [0, ERR_CAP] and the fixed size
#: of the resampled synthetic pool.  ERR_CAP is data-independent (errors
#: are clipped into the top bin); reconstruction MSE of unit-clipped data
#: rarely exceeds ~1, so 4.0 leaves headroom without wasting resolution.
ERR_BINS = 64
ERR_CAP = 4.0
ERR_POOL = 256


def clip_columns(x, clip: float) -> torch.Tensor:
    """Scale every sample column of x [m, n] to L2 norm <= ``clip``.

    The ONLY data touching the DP pipeline is the clipped matrix, so every
    sensitivity bound above holds regardless of the raw input scale.
    Columns already inside the ball are untouched (no dilation).  A tensor
    stays on its device; anything else becomes a host tensor.
    """
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, torch.device("cpu"))
    norms = torch.linalg.vector_norm(x, dim=0, keepdim=True)
    scale = torch.clamp(clip / torch.clamp(norms, min=1e-30), max=1.0)
    return x * scale


# ---------------------------------------------------------------------------
# Analytic Gaussian mechanism calibration (pure math, as the reference's)
# ---------------------------------------------------------------------------

def _phi(t: float) -> float:
    """Standard normal CDF via math.erf (no scipy dependency)."""
    return 0.5 * (1.0 + math.erf(t / math.sqrt(2.0)))


def _log_phi(t: float) -> float:
    """log of the standard normal CDF, stable for very negative t (where
    erf underflows) via the Mills-ratio asymptotic."""
    p = _phi(t)
    if p > 0.0:
        return math.log(p)
    return -0.5 * t * t - math.log(-t) - 0.5 * math.log(2.0 * math.pi)


def _gaussian_delta(sigma: float, epsilon: float) -> float:
    """Exact delta of the Gaussian mechanism at unit sensitivity
    (Balle & Wang 2018, Theorem 8): monotone decreasing in sigma.

    The e^eps * Phi(...) product is evaluated in log space so large
    epsilon (> ~700, where math.exp overflows) stays finite.
    """
    a = 1.0 / (2.0 * sigma)
    b = epsilon * sigma
    log_term2 = epsilon + _log_phi(-a - b)
    term2 = math.exp(log_term2) if log_term2 < 700.0 else math.inf
    return max(_phi(a - b) - term2, 0.0)


def calibrate_sigma(epsilon: float, delta: float) -> float:
    """Smallest sigma making the unit-sensitivity Gaussian mechanism
    (epsilon, delta)-DP, by bisection on the exact delta expression.

    Scale the result by a block's L2 sensitivity to noise that block.
    Tighter than the classical sqrt(2 ln(1.25/delta))/epsilon bound and
    valid for epsilon > 1 where the classical formula breaks down.
    """
    if not epsilon > 0:
        raise PrivacyError(f"epsilon must be > 0, got {epsilon!r}")
    if not 0.0 < delta < 1.0:
        raise PrivacyError(f"delta must be in (0, 1), got {delta!r}")
    lo, hi = 1e-8, 1.0
    while _gaussian_delta(hi, epsilon) > delta:
        hi *= 2.0
        if hi > 1e12:  # pragma: no cover - unreachable for valid (eps, delta)
            raise PrivacyError("sigma calibration failed to bracket")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _gaussian_delta(mid, epsilon) > delta:
            lo = mid
        else:
            hi = mid
    return hi


# ---------------------------------------------------------------------------
# Per-block sensitivities
# ---------------------------------------------------------------------------

def block_sensitivities(config, clip: float) -> list[tuple[str, float]]:
    """Ordered (name, joint L2 sensitivity) of every released block for a
    DAEF config (see the module docstring for the derivations)."""
    sizes = config.layer_sizes
    out: list[tuple[str, float]] = [("encoder", clip * clip)]
    for li in range(2, len(sizes) - 1):
        m_aug = sizes[li] + 1
        n_out = sizes[li - 1]
        dg = m_aug / 16.0 * math.sqrt(n_out)
        dm = math.sqrt(m_aug) * FD_BOUND * math.sqrt(n_out)
        out.append((f"layer{li}", math.hypot(dg, dm)))
    m_aug = sizes[-2] + 1
    dg = float(m_aug)
    dm = math.sqrt(m_aug) * clip
    out.append(("last", math.hypot(dg, dm)))
    out.append(("errors", 1.0))
    return out


# ---------------------------------------------------------------------------
# Noise application (all post-processing-safe helpers)
# ---------------------------------------------------------------------------

def _normal(key: torch.Tensor, shape, sigma: float, dtype, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * sigma``, drawn on the host
    with the reference's bits, then moved to ``device``.  The draw and the
    scaling are float32, as JAX's 32-bit mode makes them for any ``dtype``;
    a float64 ``dtype`` widens the result."""
    z = threefry.normal(key, tuple(shape)) * sigma
    return z.to(device=device, dtype=dtype)


def _sym_noise(key: torch.Tensor, shape, sigma: float, dtype, device=None) -> torch.Tensor:
    """Symmetric Gaussian noise: iid N(0, sigma^2) upper triangle mirrored
    below (Analyze-Gauss style), batched over any leading axes; on
    ``device`` (``None``: the host, where it is drawn)."""
    z = _normal(key, shape, sigma, dtype, device or "cpu")
    upper = torch.triu(z)
    return upper + torch.triu(z, 1).transpose(-1, -2)


def _psd_clip(g: torch.Tensor) -> torch.Tensor:
    """Project a (batched) symmetric matrix to the PSD cone by clipping
    negative eigenvalues — keeps the Cholesky solve of G + lam I valid."""
    evals, evecs = torch.linalg.eigh(g)
    return (evecs * torch.clamp(evals, min=0.0)[..., None, :]) @ evecs.transpose(-1, -2)


def _dp_ridge(lam: float, sigma: float, m_aug: int) -> float:
    """Noise-adaptive ridge for solving against a noised Gram (AdaSSP-style,
    Wang 2018): the symmetric noise perturbs G's spectrum by O(sigma *
    sqrt(m)), so eigendirections below that scale are pure noise and the
    configured lam (tuned for the exact Gram) under-regularizes them.
    Choosing lam from sigma is post-processing — sigma is public.  The 1/2
    factor keeps the bias moderate: the PSD clip applied after noising
    already removes the downward half of the spectral perturbation.
    """
    return max(float(lam), 0.5 * sigma * math.sqrt(m_aug))


def noise_stats(key: torch.Tensor, stats: rolann.RolannStats,
                sigma: float) -> rolann.RolannStats:
    """One Gaussian release of a (G, M) block: symmetric noise on G
    (PSD-clipped), dense noise on M.  ``sigma`` is already scaled by the
    block's joint sensitivity.  The result lives where ``stats`` does."""
    kg, km = threefry.split(key)
    dev = stats.g.device
    g = stats.g + _sym_noise(kg, stats.g.shape, sigma, stats.g.dtype, dev)
    m = stats.m + _normal(km, stats.m.shape, sigma, stats.m.dtype, dev)
    return rolann.RolannStats(g=_psd_clip(g), m=m)


def dp_train_errors(key: torch.Tensor, errors: torch.Tensor, sigma: float) -> torch.Tensor:
    """Release the train-error pool as a fixed-size synthetic sample.

    Clips errors into [0, ERR_CAP], builds an ERR_BINS histogram (L2
    sensitivity 1: one sample moves one count), adds Gaussian noise, then
    deterministically inverse-CDF-samples ERR_POOL values at even quantile
    positions — the resampling is post-processing and the released shape
    is independent of the site's sample count.

    The histogram has numpy's bins, as ``jnp.histogram``: [a, b) but the
    last, which is closed (``ERR_CAP - 1e-9`` is 4.0 in float32, so a
    clipped error of exactly 4.0 lands in the last bin).
    """
    dev = errors.device
    edges = torch.linspace(0.0, ERR_CAP, ERR_BINS + 1, device=dev)
    clipped = torch.clamp(errors.float(), 0.0, ERR_CAP - 1e-9)
    idx = torch.searchsorted(edges, clipped, right=True)
    idx = torch.where(clipped == edges[-1], ERR_BINS, idx)
    idx = idx[(idx >= 1) & (idx <= ERR_BINS)]  # NaNs fall outside, as in numpy
    counts = torch.bincount(idx - 1, minlength=ERR_BINS).to(torch.float32)
    counts = counts + _normal(key, counts.shape, sigma, torch.float32, dev)
    counts = torch.clamp(counts, min=0.0)
    total = torch.clamp(torch.sum(counts), min=1e-9)
    cdf = torch.cumsum(counts, dim=0) / total
    qs = (torch.arange(ERR_POOL, dtype=torch.float32, device=dev) + 0.5) / ERR_POOL
    pos = torch.searchsorted(cdf, qs)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers[torch.clamp(pos, 0, ERR_BINS - 1)]


# ---------------------------------------------------------------------------
# The private fit
# ---------------------------------------------------------------------------

def _validate(config, spec: PrivacySpec) -> None:
    if not spec.dp_enabled:
        raise PrivacyError("fit_dp called with a spec that has no epsilon — "
                           "use daef.fit for the non-private path")
    if config.method != "gram":
        raise PrivacyError(
            "fit_dp noises additive (G, M) statistics; method='svd' factors "
            "have no bounded-sensitivity release — set method='gram'"
        )
    if config.act_hidden != "logsig" or config.act_last != "linear":
        raise PrivacyError(
            "fit_dp's sensitivity bounds are derived for act_hidden='logsig' "
            f"+ act_last='linear'; got ({config.act_hidden!r}, "
            f"{config.act_last!r}) — unbounded activations make the release "
            "sensitivity unbounded"
        )


def _forward(config, x: torch.Tensor, weights, biases) -> torch.Tensor:
    """Forward a chunk through the encoder + solved decoder layers so far."""
    f_hl = activations.get(config.act_hidden)
    h = f_hl.fn(weights[0].T @ x)
    for w, b in zip(weights[1:], biases, strict=True):
        h = f_hl.fn(w.T @ h + b[:, None])
    return h


def _chunks(n: int, chunk_samples: int | None):
    step = n if not chunk_samples else max(1, int(chunk_samples))
    for start in range(0, n, step):
        yield start, min(start + step, n)


def fit_dp(config, x, key: torch.Tensor, spec: PrivacySpec,
           *, chunk_samples: int | None = None, device=None):
    """DP counterpart of `daef.fit` (gram method) — see the module doc.

    Returns a `daef.DAEFModel` whose encoder factors, layer knowledge and
    train-error pool are all (epsilon, delta)-DP releases; the weights are
    solved from the noised blocks (post-processing).  ``chunk_samples``
    bounds the per-pass activation memory exactly like `daef.fit_chunked`
    — statistics accumulate chunk by chunk and noise is added ONCE to the
    accumulated block, never per chunk.

    ``key`` ([2], a threefry key) seeds ONLY the release noise; the stage-1
    weights still come from the config's shared federated seed, so private
    sites merge with the same algebra as public ones.  ``x`` [m0, n] is
    moved to ``device`` (``None``: the card), where the fit runs.
    """
    from repro_torch.core import daef  # deferred, as the reference's

    config = config.resolved(device)
    _validate(config, spec)
    x = as_tensor(x, resolve_device(device))
    m0, n = x.shape
    if m0 != config.layer_sizes[0]:
        raise ValueError(f"input dim {m0} != layer_sizes[0] "
                         f"{config.layer_sizes[0]}")
    x = clip_columns(x, spec.clip)
    dev, dtype = x.device, x.dtype
    f_hl = activations.get(config.act_hidden)
    f_ll = activations.get(config.act_last)
    sizes = config.layer_sizes
    keys = config.layer_keys()

    # Budget split across blocks proportional to sensitivity^(2/3) — the
    # allocation that minimizes total squared noise under basic composition
    # (minimize sum (Delta_i/eps_i)^2 subject to sum eps_i = eps).  The
    # weights depend only on public quantities (layer sizes, clip), so the
    # split itself costs no privacy.
    sens = block_sensitivities(config, spec.clip)
    n_blocks = len(sens)
    weights_eps = [delta2 ** (2.0 / 3.0) for _, delta2 in sens]
    w_total = sum(weights_eps)
    block_keys = threefry.split(key, n_blocks)
    sigmas = {
        name: calibrate_sigma(spec.epsilon * w / w_total,
                              spec.delta * w / w_total) * delta2
        for (name, delta2), w in zip(sens, weights_eps)
    }

    # ---- block 1: encoder Gram, noised once at full rank ----
    g_enc = torch.zeros((m0, m0), dtype=dtype, device=dev)
    for a, b in _chunks(n, chunk_samples):
        g_enc = g_enc + dsvd.gram(x[:, a:b])
    g_enc = g_enc + _sym_noise(block_keys[0], g_enc.shape, sigmas["encoder"], dtype, dev)
    # gram_to_factors already clips negative eigenvalues — the released
    # encoder factors are the PSD projection of the noised Gram.
    enc = dsvd.gram_to_factors(g_enc)
    w_enc = enc.u[:, : config.latent_dim]

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---- hidden decoder layers: accumulate, noise, solve, advance ----
    for li in range(2, len(sizes) - 1):
        w_c1, b_c1 = elm_ae.stage1(keys[li], sizes[li - 1], sizes[li],
                                   config.init, dtype, dev)
        stats = rolann.init_stats(sizes[li], sizes[li - 1], f_hl, dtype, device=dev)
        for a, b in _chunks(n, chunk_samples):
            h = _forward(config, x[:, a:b], weights, biases)
            stats = elm_ae.accumulate_layer_stats(
                stats, w_c1, b_c1, h, f_hl, backend=config.stats_backend
            )
        stats = noise_stats(block_keys[li - 1], stats, sigmas[f"layer{li}"])
        lam_hl = _dp_ridge(config.lam_hidden, sigmas[f"layer{li}"],
                           sizes[li] + 1)
        w_next, b_next = elm_ae.layer_from_knowledge(
            stats, keys[li], sizes[li - 1], sizes[li], lam_hl,
            f_hl, init=config.init, aux_bias=config.aux_bias, dtype=dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w_next)
        biases.append(b_next)
        knowledge.append(stats)

    # ---- last layer against the (clipped) inputs ----
    stats = rolann.init_stats(sizes[-2], m0, f_ll, dtype, device=dev)
    for a, b in _chunks(n, chunk_samples):
        h = _forward(config, x[:, a:b], weights, biases)
        stats = rolann.accumulate_stats(
            stats, h, x[:, a:b], f_ll, backend=config.stats_backend
        )
    stats = noise_stats(block_keys[-2], stats, sigmas["last"])
    lam_ll = _dp_ridge(config.lam_last, sigmas["last"], sizes[-2] + 1)
    w_ll, b_ll = rolann.solve(stats, lam_ll, gram_solver=config.gram_solver)
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(stats)

    # ---- train errors: noised-histogram synthetic pool ----
    errs = []
    for a, b in _chunks(n, chunk_samples):
        h = _forward(config, x[:, a:b], weights[:-1], biases[:-1])
        recon = f_ll.fn(w_ll.T @ h + b_ll[:, None])
        errs.append(torch.mean((recon - x[:, a:b]) ** 2, dim=0))
    train_errors = dp_train_errors(block_keys[-1], torch.cat(errs),
                                   sigmas["errors"])

    return daef.DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=train_errors,
    )
