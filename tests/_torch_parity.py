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


def assert_models_match(jm, tm, lam_last: float, *, s_as_sum: bool = False) -> None:
    """A port ``DAEFModel`` against a reference one, leaf by leaf, under the
    rules tests/test_torch_daef.py states: ``TOLS`` for the encoder and
    hidden weights and biases, the singular values and the train errors;
    ``assert_sum_close`` for the per-layer (G, M) and the encoder's U S² Uᵀ;
    10·κ·eps·max|[W; b]| for the last layer's W and b, κ the largest
    condition number of its ``G + λI`` (float32 noise in h moves w by up to
    κ·eps relative).

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
