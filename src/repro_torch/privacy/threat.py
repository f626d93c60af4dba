"""Adversary model for the DAEF exchange + a working reconstruction demo
(a copy of ``repro/privacy/threat.py``; numpy only).

The paper argues that exchanging the per-layer sufficient statistics
(G, M) instead of raw data "does not endanger the privacy of the users".
That is an ACCESS-CONTROL argument, not a privacy guarantee.  This
module makes the gap concrete so docs/privacy.md can cite running code:

Adversary model (honest-but-curious)
------------------------------------
* The broker follows the protocol but inspects everything it receives:
  per-site encoder Grams / factors, per-layer (G, M), train-error pools.
* Sites may collude with the broker by sharing what they know (their own
  data, the shared stage-1 seed — which is public protocol state anyway).
* Nobody tampers with messages (no malicious/Byzantine behaviour; that
  is out of scope for this tier).

What (G, M) leaks without protection
------------------------------------
The encoder statistic is literally ``G = sum_i x_i x_i^T``.  For a site
holding ONE sample, ``G = x x^T`` is rank one and `reconstruct_rank1`
recovers the sample exactly (up to sign) from the top eigenpair.  With a
few samples, G still pins the data's span and norms; M-vectors add
activation-weighted column sums.  The train-error pool is per-sample by
construction.  None of this is an attack on the protocol — it is what
the exchanged numbers ARE.

What the privacy tier buys
--------------------------
* `privacy.secagg` hides every INDIVIDUAL site's statistics from the
  broker (it sees only the round aggregate) — but the aggregate itself
  still leaks, and colluding sites can subtract their own contributions.
* `privacy.dp` bounds what ANY release reveals about any single sample,
  including against colluders, at a measured accuracy cost
  (benchmarks/privacy_tradeoff.py).

Compose both for broker-blinding AND per-sample deniability.
"""
from __future__ import annotations

import numpy as np
import torch

Array = np.ndarray | torch.Tensor


def _host(a) -> np.ndarray:
    """A numpy array, a host or card tensor as float64 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def reconstruct_rank1(g: Array) -> np.ndarray:
    """Recover x (up to sign) from a single-sample Gram G = x x^T.

    The top eigenpair (lam, v) of a rank-one PSD matrix gives
    ``x = +- sqrt(lam) v`` exactly — the honest-but-curious broker runs
    this on any site block whose G is (near) rank one.
    """
    g = _host(g)
    evals, evecs = np.linalg.eigh(g)
    lam, v = evals[-1], evecs[:, -1]
    return np.sqrt(max(lam, 0.0)) * v


def reconstruction_error(x: Array, g: Array) -> float:
    """Relative L2 error of the rank-1 reconstruction of sample ``x`` from
    Gram ``g``, minimized over the sign ambiguity (0.0 == exact leak)."""
    x = _host(x).reshape(-1)
    rec = reconstruct_rank1(g)
    err = min(np.linalg.norm(rec - x), np.linalg.norm(rec + x))
    return float(err / max(np.linalg.norm(x), 1e-30))


def demo(n_features: int = 8, seed_vector=None) -> dict:
    """The docs/privacy.md demo: a site with one sample publishes its
    encoder Gram; the broker reconstructs the sample.

    ``seed_vector`` is the "private" sample (defaults to a fixed
    deterministic vector — this is an expository demo, not an
    experiment).  Returns the relative reconstruction error (~1e-7,
    i.e. an exact leak up to float precision).
    """
    if seed_vector is None:
        x = np.sin(np.arange(1, n_features + 1, dtype=np.float64))
    else:
        x = np.asarray(seed_vector, dtype=np.float64).reshape(-1)
    g = np.outer(x, x)  # what the site would publish: its encoder Gram
    return {
        "n_features": int(x.size),
        "relative_error": reconstruction_error(x, g),
        "reconstruction": reconstruct_rank1(g),
        "sample": x,
    }
