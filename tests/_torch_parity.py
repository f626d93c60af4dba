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
