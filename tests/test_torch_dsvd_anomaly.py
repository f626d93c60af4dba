"""repro_torch.core.dsvd (gram route, the merges of Eq. 2, a leading tenant axis)
and core.anomaly against the reference."""
import jax
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


# ---- the merges of Eq. 2 and the fleet's leading tenant axis ----

def _uu(f):
    """U S^2 U^T of factors (the merge-invariant part; trailing columns of U
    belong to near-equal noise eigenvalues that float32 does not fix)."""
    u, s = (np.asarray(a, np.float64) if not isinstance(a, torch.Tensor) else
            a.double().numpy() for a in f)
    return (u * s[..., None, :] ** 2) @ np.swapaxes(u, -1, -2)


@pytest.mark.parametrize("rank", [None, 4])
def test_local_svd(rank):
    x = lowrank_data(10, 4, 300, seed=7)
    got = tdsvd.local_svd(torch.from_numpy(x), rank)
    want = jdsvd.local_svd(jnp.asarray(x), rank)
    assert tuple(got.u.shape) == want.u.shape and tuple(got.s.shape) == want.s.shape
    assert_close(got.s, want.s)
    assert_close(got.u[:, :4], want.u[:, :4])  # the signal's columns, signs canonical
    assert_sum_close(_uu(got), _uu(want))


@pytest.mark.parametrize("batched", [False, True])
def test_merge_factors_and_pair(batched):
    """Eq. 2 on two and three parts; merge_pair is the two-part case.  With
    a leading tenant axis every tenant merges its own factors."""
    xs = [lowrank_data(10, 4, n, seed=n) for n in (200, 150, 90)]
    parts_t = [tdsvd.local_svd(torch.from_numpy(x)) for x in xs]
    parts_j = [jdsvd.local_svd(jnp.asarray(x)) for x in xs]
    if batched:  # tenant t holds part t's factors scaled by (t + 1)
        def stack(parts, lib):
            return type(parts[0])(u=lib.stack([parts[0].u] * 3),
                                  s=lib.stack([parts[0].s * (t + 1) for t in range(3)]))
        parts_t = [stack([p], torch) for p in parts_t]
        parts_j = [stack([p], jnp) for p in parts_j]
    for n_parts in (2, 3):
        got = tdsvd.merge_factors(parts_t[:n_parts])
        if batched:
            want = jax.vmap(lambda *ps: jdsvd.merge_factors(ps))(*parts_j[:n_parts])
        else:
            want = jdsvd.merge_factors(parts_j[:n_parts])
        assert tuple(got.u.shape) == want.u.shape
        assert_close(got.s, want.s)
        assert_sum_close(_uu(got), _uu(want))
    pair = tdsvd.merge_pair(parts_t[0], parts_t[1])
    two = tdsvd.merge_factors(parts_t[:2])
    assert torch.equal(pair.u, two.u) and torch.equal(pair.s, two.s)
    if not batched:  # the merge is the SVD of the concatenated data
        whole = tdsvd.local_svd(torch.from_numpy(np.concatenate(xs[:2], axis=1)))
        assert_close(pair.s, whole.s)
        assert_sum_close(_uu(pair), _uu(whole))


def test_pad_rank():
    f = tdsvd.local_svd(torch.from_numpy(lowrank_data(6, 2, 4, seed=1)))  # rank 4 of 6
    padded = tdsvd.pad_rank(f, 6)
    want = jdsvd.pad_rank(jdsvd.local_svd(jnp.asarray(lowrank_data(6, 2, 4, seed=1))), 6)
    assert tuple(padded.u.shape) == want.u.shape == (6, 6)
    assert not padded.s[4:].any() and not padded.u[:, 4:].any()
    assert_sum_close(_uu(padded), _uu(f))
    assert tdsvd.pad_rank(f, 4) is f
    batch = tdsvd.pad_rank(tdsvd.SvdFactors(u=f.u[None].expand(3, 6, 4), s=f.s[None].expand(3, 4)), 5)
    assert tuple(batch.u.shape) == (3, 6, 5) and tuple(batch.s.shape) == (3, 5)
    with pytest.raises(ValueError) as terr:
        tdsvd.pad_rank(f, 3)
    with pytest.raises(ValueError) as jerr:
        jdsvd.pad_rank(jdsvd.SvdFactors(u=jnp.asarray(f.u.numpy()), s=jnp.asarray(f.s.numpy())), 3)
    assert str(terr.value) == str(jerr.value)


def test_canonicalize_signs_and_gram_factors_batched():
    """With a leading tenant axis, tenant by tenant the one-tenant result."""
    rng = np.random.default_rng(8)
    u = rng.normal(size=(3, 9, 6)).astype(np.float32)
    u[1, :, 2] = 0.0
    got = tdsvd.canonicalize_signs(torch.from_numpy(u))
    for t in range(3):
        assert torch.equal(got[t], tdsvd.canonicalize_signs(torch.from_numpy(u[t])))
    x = np.stack([lowrank_data(10, 4, 400, seed=s) for s in range(3)])
    g = torch.from_numpy(x) @ torch.from_numpy(x).transpose(-1, -2)
    f = tdsvd.gram_to_factors(g)
    for t in range(3):
        one = tdsvd.gram_to_factors(g[t])
        assert_close(f.s[t], one.s)
        assert_close(f.u[t][:, :4], one.u[:, :4])


@pytest.mark.parametrize("rule", ["extreme_iqr", "unusual_iqr", "q90"])
def test_fleet_thresholds_per_row(rule):
    """Errors [K, n] give one threshold per tenant, NaNs (padding) ignored,
    as jax.vmap(anomaly.threshold) gives."""
    e = np.stack([_errors(seed=s, nan_at=(3, 17) if s == 1 else ()) for s in range(4)])
    got = tan.threshold(e, rule, device="cpu")
    assert tuple(got.shape) == (4,)
    want = jax.vmap(lambda row: jan.threshold(row, rule))(jnp.asarray(e))
    assert_close(got, want)
    for t in range(4):
        assert_close(got[t], tan.threshold(e[t], rule, device="cpu"))
