"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The same numpy inputs, made from a seed, go through the JAX function and its
``repro_torch`` counterpart; results come back as numpy and are compared with
the repo's parity bar, ``TOLS`` of tests/test_parity.py (float32:
atol = rtol = 1e-4), unless a test states another tolerance and its reason.

Importing this module pins torch to one intra-op thread: the tier-1 run puts
six test workers on the machine's cores, and the port's tests are small.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)

TOLS = {
    "float32": dict(atol=1e-4, rtol=1e-4),
    "float64": dict(atol=1e-9, rtol=1e-9),
}
F32 = TOLS["float32"]
EPS32 = float(np.finfo(np.float32).eps)


def lowrank_data(m0: int, latent: int, n: int, seed: int) -> np.ndarray:
    """Standardized low-rank-plus-noise data [m0, n] (float32), the shape of
    data DAEF is built for (tests/test_parity.py's ``_data``, one tenant)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(latent, n))
    mix = rng.normal(size=(m0, latent))
    x = mix @ np.tanh(z) + 0.1 * rng.normal(size=(m0, n))
    x = (x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)
    return x.astype(np.float32)


def to_np(t) -> np.ndarray:
    """A torch tensor or JAX array as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_close(actual, desired, *, what: str = "", **tol) -> None:
    """``np.testing.assert_allclose`` with ``TOLS`` float32 by default."""
    np.testing.assert_allclose(to_np(actual), to_np(desired), err_msg=what,
                               **(tol or F32))


def assert_sum_close(actual, desired, *, what: str = "") -> None:
    """Compare a sum over samples (a Gram or M statistic).

    Its float32 rounding error grows with the size of the summed terms, not
    with the result: an entry near zero after cancellation carries an error
    of order ``n * eps * max|term|``.  So the absolute part of ``TOLS``
    scales with the largest entry: atol = 1e-4 * max(1, max|desired|),
    rtol = 1e-4 (``tests/test_kernels.py`` does the same at 2e-4).
    """
    d = to_np(desired)
    scale = max(1.0, float(np.abs(d).max())) if d.size else 1.0
    np.testing.assert_allclose(to_np(actual), d, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


def cancellation_bar(jm, lam_last: float) -> float:
    """The last layer's W and b where its M is the small remainder of a
    cancelling sum (a linear last layer, ``G`` [m, m]).

    M = Σ_j h_j t_jᵀ over n samples is rounded relative to the sum of its
    terms' magnitudes, not to its value: one eps on each entry gives
    |δM_ik| ≤ eps·Σ_j |h_ij t_kj| ≤ eps·sqrt(G_ii·T_k) (Cauchy–Schwarz, T_k
    = Σ_j t_kj²), and the solve moves column k of [W; b] by at most
    ‖δM_·k‖₂ / (σ_min(G) + λ).  The targets of a linear last layer are the
    inputs, so T_k is the diagonal of the encoder's Gram U S² Uᵀ.  Where the
    terms cancel to ~1e-3 of their size (tenants whose last layer is nearly
    all regularizer), this exceeds the κ bar, which scales with |W|: the
    port and the reference then agree to ~5e-15 in float64, each float32
    fit sits up to 3.5e-6 from that, and the two float32 fits up to 4.7e-6
    apart, 0.06–0.18 of this bar (9-3-5-7-9 nets on
    ``lowrank_data(9, 3, 120, s)``, 16 seeds below 40; ROADMAP queue C)."""
    g = np.asarray(jm.layer_knowledge[-1].g, np.float64)
    if g.ndim != 2:
        raise ValueError("cancellation_bar needs a linear last layer's shared G [m, m]")
    u, s = (np.asarray(a, np.float64) for a in jm.encoder_factors)
    t = np.einsum("ij,j,ij->i", u, s**2, u)                       # Σ_j x_kj²
    terms = np.sqrt(np.clip(np.diag(g), 0, None))[:, None] * np.sqrt(np.clip(t, 0, None))[None]
    sigma_min = float(np.linalg.eigvalsh(g)[0])
    return EPS32 * float(np.linalg.norm(terms, axis=0).max()) / (sigma_min + lam_last)


def assert_models_match(jm, tm, lam_last: float, *, s_as_sum: bool = False,
                        m_cancels: bool = False) -> None:
    """A port ``DAEFModel`` against a reference one, leaf by leaf, under the
    rules tests/test_torch_daef.py states: ``TOLS`` for the encoder and
    hidden weights and biases, the singular values and the train errors;
    ``assert_sum_close`` for the per-layer (G, M) and the encoder's U S² Uᵀ;
    10·κ·eps·max|[W; b]| for the last layer's W and b, κ the largest
    condition number of its ``G + λI`` (float32 noise in h moves w by up to
    κ·eps relative).

    ``m_cancels`` raises the last layer's bar to :func:`cancellation_bar`
    where that is larger: for data whose last-layer M cancels, the rounding
    of M is relative to its terms, which the κ bar does not cover.

    ``s_as_sum`` holds S² — the eigenvalues of the summed encoder Gram —
    to ``assert_sum_close`` instead of S to ``TOLS``: for data that is not
    centred, float32 ``eigh`` fixes a small singular value s only to about
    eps·λ_max/(2s), more than 1e-4 when λ_max/s² is in the thousands (the
    reference's own one-shot and chunked fits then differ by that much)."""
    n_w = len(jm.weights)
    for i in range(n_w - 1):
        assert_close(tm.weights[i], jm.weights[i], what=f"weights[{i}]")
    for i in range(n_w - 2):
        assert_close(tm.biases[i], jm.biases[i], what=f"biases[{i}]")
    # last layer: tolerance from the conditioning of its solve
    k_last = jm.layer_knowledge[-1]
    g = np.asarray(k_last.g, np.float64)
    kappa = float(np.max(np.linalg.cond(g + lam_last * np.eye(g.shape[-1]))))
    w_aug = np.concatenate([np.asarray(jm.weights[-1]), np.asarray(jm.biases[-1])[None]])
    atol = 10.0 * kappa * EPS32 * float(np.abs(w_aug).max())
    if m_cancels:
        atol = max(atol, cancellation_bar(jm, lam_last))
    assert_close(tm.weights[-1], jm.weights[-1], atol=atol, rtol=0, what="last W")
    assert_close(tm.biases[-1], jm.biases[-1], atol=atol, rtol=0, what="last b")
    # encoder factors
    ju, js = (np.asarray(a) for a in jm.encoder_factors)
    tu, ts = (to_np(a) for a in tm.encoder_factors)
    if s_as_sum:
        assert_sum_close(ts**2, js**2, what="encoder S^2")
    else:
        assert_close(ts, js, what="encoder S")
    assert_sum_close((tu * ts**2) @ tu.T, (ju * js**2) @ ju.T, what="encoder U S^2 U^T")
    # per-layer knowledge
    assert len(tm.layer_knowledge) == len(jm.layer_knowledge)
    for i, (tk, jk) in enumerate(zip(tm.layer_knowledge, jm.layer_knowledge)):
        assert_sum_close(tk.g, jk.g, what=f"knowledge[{i}].g")
        assert_sum_close(tk.m, jk.m, what=f"knowledge[{i}].m")
    assert_close(tm.train_errors, jm.train_errors, what="train errors")
