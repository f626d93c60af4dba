"""repro_torch.core.dsvd (gram route) and core.anomaly against the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close, lowrank_data

from repro.core import anomaly as jan
from repro.core import dsvd as jdsvd
from repro_torch.core import anomaly as tan
from repro_torch.core import dsvd as tdsvd


def test_canonicalize_signs():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(9, 6)).astype(np.float32)
    u[:, 2] = 0.0  # an all-zero column keeps sign +1
    got = tdsvd.canonicalize_signs(torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdsvd.canonicalize_signs(jnp.asarray(u))))


@pytest.mark.parametrize("n_parts", [1, 3, 4])
def test_dsvd_gram_route(n_parts):
    x = lowrank_data(10, 4, 900, seed=n_parts)
    bounds = [round(i * 900 / n_parts) for i in range(n_parts + 1)]
    parts = [x[:, bounds[i]:bounds[i + 1]] for i in range(n_parts)]
    got = tdsvd.dsvd([torch.from_numpy(p) for p in parts], rank=6, method="gram")
    want = jdsvd.dsvd([jnp.asarray(p) for p in parts], rank=6, method="gram")
    assert tuple(got.u.shape) == (10, 6) and tuple(got.s.shape) == (6,)
    assert_close(got.s, want.s)
    # The leading singular vectors (the encoder weights) are well separated
    # from the rest on this low-rank data and compare entry by entry.
    assert_close(got.u[:, :4], want.u[:, :4])
    # U S^2 U^T is what merges consume; it holds at the Gram's sum tolerance.
    gu = (got.u * got.s**2) @ got.u.T
    wu = (want.u * want.s**2) @ want.u.T
    assert_sum_close(gu, wu)


def test_gram_to_factors_descending_and_clipped():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 3)).astype(np.float32)
    g = a @ a.T  # rank 3: three eigenvalues are ~0 and may come out negative
    f = tdsvd.gram_to_factors(torch.from_numpy(g))
    s = f.s.numpy()
    assert np.all(np.diff(s) <= 0) and np.all(s >= 0)
    want = jdsvd.gram_to_factors(jnp.asarray(g))
    assert_close(f.s[:3], want.s[:3])
    assert_close(f.u[:, :3], want.u[:, :3])
    t = tdsvd.truncate(f, 2)
    assert tuple(t.u.shape) == (6, 2) and tuple(t.s.shape) == (2,)


def test_dsvd_svd_route_not_ported():
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        tdsvd.dsvd([torch.zeros(3, 4)], rank=2, method="svd")
    with pytest.raises(ValueError, match="unknown DSVD method"):
        tdsvd.dsvd([torch.zeros(3, 4)], rank=2, method="qr")


def _errors(seed=0, n=997, nan_at=()):
    rng = np.random.default_rng(seed)
    e = rng.gamma(2.0, 0.5, size=n).astype(np.float32)
    e[list(nan_at)] = np.nan
    return e


@pytest.mark.parametrize("rule", ["extreme_iqr", "unusual_iqr", "q90", "q97.5", "q05"])
@pytest.mark.parametrize("nan_at", [(), (3, 17, 500)])
def test_threshold(rule, nan_at):
    e = _errors(nan_at=nan_at)
    got = tan.threshold(e, rule, device="cpu")
    assert got.ndim == 0
    want = jan.threshold(jnp.asarray(e), rule)
    assert np.isfinite(got.item())
    assert_close(got, want)


def test_parse_quantile_rule():
    for rule in ["q90", "q97.5", "q05", "extreme_iqr", "qx", "iqr"]:
        assert tan.parse_quantile_rule(rule) == jan.parse_quantile_rule(rule)
    for bad in ["q0", "q100", "q150"]:
        with pytest.raises(ValueError, match="quantile percent"):
            tan.parse_quantile_rule(bad)
    with pytest.raises(ValueError, match="unknown threshold rule"):
        tan.threshold(_errors(), "median", device="cpu")


def test_classify_metrics_and_evaluate():
    train = _errors(1)
    test = _errors(2, n=400)
    truth = (np.random.default_rng(3).uniform(size=400) < 0.3).astype(np.int32)
    mu = tan.threshold(train, device="cpu")
    pred = tan.classify(test, mu, device="cpu")
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jan.classify(jnp.asarray(test), jnp.asarray(mu.item()))))
    got = tan.binary_metrics(pred, truth, device="cpu")
    want = jan.binary_metrics(np.asarray(pred), truth)
    assert got.__dict__ == want.__dict__
    got_e = tan.evaluate(train, test, truth, "q90", device="cpu")
    want_e = jan.evaluate(jnp.asarray(train), jnp.asarray(test), truth, "q90")
    assert got_e.__dict__ == want_e.__dict__


def test_metrics_degenerate():
    m = tan.binary_metrics(np.zeros(5, np.int32), np.zeros(5, np.int32), device="cpu")
    assert (m.f1, m.precision, m.recall, m.accuracy, m.tn) == (0.0, 0.0, 0.0, 1.0, 5)
