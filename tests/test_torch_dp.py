"""repro_torch.privacy.dp / threat, threefry.fold_in and the port session's
DP rounds against repro.privacy (tests/test_privacy.py's DP cases).

Tolerances, and why:

* Keys (``fold_in``, the session's ``_dp_key``), every noise draw
  (``_sym_noise``, ``noise_stats``' M noise and its G draw,
  ``dp_train_errors``' count noise) and the calibration numbers
  (``calibrate_sigma``, ``block_sensitivities``, ``FD_BOUND``) are held
  bit-identical: the port's threefry ``normal`` reproduces XLA's CPU
  ``erf_inv`` (its log1p and fused multiply-adds), so the same key gives
  the same float32 noise.
* Released (G, M) blocks and weights go through ``assert_models_match``:
  ``TOLS`` for the encoder and hidden layers, ``assert_sum_close`` for the
  statistics and the encoder's U S² Uᵀ, and the last layer's W and b at
  10·κ·eps·max|[W; b]| with κ of ``G + λI`` at the release's noise-adaptive
  ridge λ (``dp._dp_ridge``), test_torch_daef.py's rule.
* The released train-error pool is 256 bin centres read off a noised CDF.
  Its counts are exact and its noise bit-identical, but ``sum`` and
  ``cumsum`` of 64 float32 counts may round in another order than XLA's,
  so a quantile position within float32 rounding of a CDF step may pick the
  neighbouring bin.  The pools must be equal except at positions within
  1e-5 of a CDF step of the float64 CDF of the noised counts.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, to_np

from repro.core import daef as jdaef
from repro.core import rolann as jrolann
from repro.data import synthetic as jsynthetic
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.privacy import PrivacyBudgetExceeded as JBudgetExceeded
from repro.privacy import PrivacyError as JPrivacyError
from repro.privacy import PrivacySpec as JSpec
from repro.privacy import dp as jdp
from repro.privacy import threat as jthreat
from repro_torch.core import daef as tdaef
from repro_torch.core import rolann, threefry
from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError
from repro_torch.privacy import (PrivacyBudgetExceeded, PrivacyError, PrivacySpec, dp,
                                 threat)

LAM_H, LAM_L = 0.9, 0.9


@functools.lru_cache(maxsize=None)
def _data(n_sites=2, n=150):
    """Contiguous site blocks of the synthetic cardio training split."""
    x = jsynthetic.make_dataset("cardio", seed=0, scale=0.25).train_test_split(fold=0)[0]
    out = []
    for s in range(n_sites):
        p = np.ascontiguousarray(x[:, s * n:(s + 1) * n], np.float32)
        p.flags.writeable = False
        out.append(p)
    return tuple(out)


M0 = _data()[0].shape[0]
LAYERS = (M0, 4, 8, M0)


def _kw(**kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=LAM_H, lam_last=LAM_L,
                     stats_backend="einsum"), **kw)


def _tcfg(**kw):
    return tdaef.DAEFConfig(**_kw(**kw))


def _jcfg(**kw):
    return jdaef.DAEFConfig(**_kw(**kw))


def _keys(seed):
    return jax.random.PRNGKey(seed), threefry.PRNGKey(seed)


def _jkey_words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _ridge_last(cfg, spec) -> float:
    """The last layer's λ in a release under ``spec`` (``dp._dp_ridge``)."""
    sens = dp.block_sensitivities(cfg, spec.clip)
    w = [d ** (2.0 / 3.0) for _, d in sens]
    _, d = sens[-2]
    sigma = dp.calibrate_sigma(spec.epsilon * w[-2] / sum(w),
                               spec.delta * w[-2] / sum(w)) * d
    return dp._dp_ridge(cfg.lam_last, sigma, cfg.layer_sizes[-2] + 1)


def _pool_match(tpool, jpool, counts_noised) -> None:
    """The module docstring's rule for the released error pool."""
    t, j = to_np(tpool), to_np(jpool)
    c = np.maximum(np.asarray(counts_noised, np.float64), 0.0)
    cdf = np.cumsum(c) / max(c.sum(), 1e-9)
    qs = (np.arange(dp.ERR_POOL) + 0.5) / dp.ERR_POOL
    near = np.min(np.abs(qs[:, None] - cdf[None, :]), axis=1) < 1e-5
    assert np.array_equal(t[~near], j[~near]), "pool differs away from a CDF step"


# ---------------------------------------------------------------------------
# keys and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_fold_in_is_bit_exact(seed):
    jk, tk = _keys(seed)
    for data in (0, 1, 2, 12345, 2**31 - 1, 2**32 - 1,
                 zlib.crc32(repr("a").encode()) & 0x7FFFFFFF):
        want = _jkey_words(jax.random.fold_in(jk, data))
        np.testing.assert_array_equal(threefry.fold_in(tk, data).numpy(), want)


@pytest.mark.parametrize("seed", [0, 3, 123456])
@pytest.mark.parametrize("shape", [(4096,), (29, 29), (3, 30, 30)])
def test_normal_draws_are_bit_exact(seed, shape):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    np.testing.assert_array_equal(threefry.normal(tk, shape).numpy(), want)


@pytest.mark.parametrize("federation", ["sync", "async"])
def test_dp_keys_match_the_reference(federation):
    plan = dict(federation=federation, merge="pairwise")
    js = JEngine(_jcfg(), JPlan(**plan, privacy=JSpec(epsilon=8.0))).session()
    ts = DAEFEngine(_tcfg(), ExecutionPlan(**plan, privacy=PrivacySpec(epsilon=8.0)),
                    device="cpu").session()
    seen = set()
    for tick in (1, 2):
        for s in (js, ts):
            s.clock = s.rounds_run = tick
        for site in (0, "a"):
            for occ in (0, 1):
                want = _jkey_words(js._dp_key(site, occ))
                got = ts._dp_key(site, occ)
                np.testing.assert_array_equal(got.numpy(), want)
                seen.add(tuple(got.tolist()))
    assert len(seen) == 8  # no two releases share a key


def test_calibration_matches_the_reference():
    for eps, delta in ((0.25, 1e-5), (1.0, 1e-5), (8.0, 1e-6), (1000.0, 1e-5)):
        assert dp.calibrate_sigma(eps, delta) == jdp.calibrate_sigma(eps, delta)
        assert dp._gaussian_delta(2.0, eps) == jdp._gaussian_delta(2.0, eps)
    assert dp.FD_BOUND == jdp.FD_BOUND
    assert (dp.ERR_BINS, dp.ERR_CAP, dp.ERR_POOL) == (jdp.ERR_BINS, jdp.ERR_CAP,
                                                       jdp.ERR_POOL)
    for clip in (1.0, 0.5):
        for layers in (LAYERS, (29, 15, 18, 21, 24, 27, 29)):
            assert (dp.block_sensitivities(_tcfg(layer_sizes=layers), clip)
                    == jdp.block_sensitivities(_jcfg(layer_sizes=layers), clip))
    assert dp._dp_ridge(0.9, 3.0, 9) == jdp._dp_ridge(0.9, 3.0, 9)
    for bad in ((0.0, 1e-5), (1.0, 0.0), (1.0, 1.0)):
        with pytest.raises(PrivacyError) as terr:
            dp.calibrate_sigma(*bad)
        with pytest.raises(JPrivacyError) as jerr:
            jdp.calibrate_sigma(*bad)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape", [(8, 8), (3, 9, 9)])
def test_sym_noise_is_bit_identical(shape):
    jk, tk = _keys(11)
    want = np.asarray(jdp._sym_noise(jk, shape, 2.5, jnp.float32))
    got = dp._sym_noise(tk, shape, 2.5, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(got.numpy(), -1, -2))


@pytest.mark.parametrize("shared", [False, True], ids=["per-output G", "shared G"])
def test_noise_stats_draws_are_bit_identical(shared):
    rng = np.random.default_rng(2)
    o, m = 4, 6
    a = rng.normal(size=(o, m, m)).astype(np.float32)
    g = a @ np.swapaxes(a, -1, -2) + 5 * np.eye(m, dtype=np.float32)
    if shared:
        g = g[0]
    mz = np.zeros((o, m), np.float32)
    jk, tk = _keys(4)
    jout = jdp.noise_stats(jk, jrolann.RolannStats(g=jnp.asarray(g), m=jnp.asarray(mz)), 0.3)
    tout = dp.noise_stats(tk, rolann.RolannStats(g=torch.from_numpy(g), m=torch.from_numpy(mz)),
                          0.3)
    # M = 0 + its draw: the draw itself, bit for bit
    np.testing.assert_array_equal(tout.m.numpy(), np.asarray(jout.m))
    # G's draw bit for bit; the PSD clip after it is an eigh (float32, TOLS
    # of the largest entry)
    kg = jax.random.split(jk)[0]
    np.testing.assert_array_equal(
        dp._sym_noise(threefry.split(tk)[0], g.shape, 0.3, torch.float32).numpy(),
        np.asarray(jdp._sym_noise(kg, g.shape, 0.3, jnp.float32)))
    assert_close(tout.g, jout.g, atol=1e-5 * float(np.abs(g).max()), rtol=1e-5)
    assert_close(dp._psd_clip(torch.from_numpy(g)), jdp._psd_clip(jnp.asarray(g)),
                 atol=1e-5 * float(np.abs(g).max()), rtol=1e-5)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 12.0])
def test_dp_train_errors_match_the_reference(sigma):
    rng = np.random.default_rng(5)
    errors = np.concatenate([rng.gamma(2.0, 0.3, size=500),
                             [0.0, 0.0625, 2.0, 4.0, 3.99, 7.5, 4.0]])
    errors = errors.astype(np.float32)
    jk, tk = _keys(9)
    want = jdp.dp_train_errors(jk, jnp.asarray(errors), sigma)
    got = dp.dp_train_errors(tk, torch.from_numpy(errors), sigma)
    assert got.shape == (dp.ERR_POOL,) and got.dtype == torch.float32
    # the count noise, bit for bit
    noise = np.asarray(jax.random.normal(jk, (dp.ERR_BINS,))) * np.float32(sigma)
    np.testing.assert_array_equal(
        dp._normal(tk, (dp.ERR_BINS,), sigma, torch.float32, "cpu").numpy(), noise)
    # numpy's histogram: [a, b) bins (0.0625 and 2.0 open bins 1 and 32), the
    # last closed (3.99, 4.0 twice and 7.5 clipped to 4.0 land in bin 63)
    counts = np.histogram(np.clip(errors, 0, np.float32(dp.ERR_CAP - 1e-9)),
                          bins=np.linspace(0, dp.ERR_CAP, dp.ERR_BINS + 1))[0]
    assert counts[-1] == 4 and counts[1] >= 1 and counts[32] >= 1
    _pool_match(got, want, counts.astype(np.float32) + noise)


# ---------------------------------------------------------------------------
# fit_dp
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_fit(eps, chunk, seed):
    x = _data()[0]
    return jdp.fit_dp(_jcfg(), x, jax.random.PRNGKey(seed), JSpec(epsilon=eps),
                      chunk_samples=chunk)


def _release_counts(cfg, model, x, spec, key):
    """The noised histogram counts of ``model``'s error release (host float32)."""
    xc = dp.clip_columns(torch.from_numpy(np.array(x)), spec.clip)
    errs = tdaef.reconstruction_error(cfg, model, xc, device="cpu")
    clipped = np.clip(errs.numpy(), 0, np.float32(dp.ERR_CAP - 1e-9))
    counts = np.histogram(clipped, bins=np.linspace(0, dp.ERR_CAP, dp.ERR_BINS + 1))[0]
    sens = dp.block_sensitivities(cfg, spec.clip)
    w = [d ** (2.0 / 3.0) for _, d in sens]
    sigma = dp.calibrate_sigma(spec.epsilon * w[-1] / sum(w), spec.delta * w[-1] / sum(w))
    k_err = threefry.split(key, len(sens))[-1]
    return counts.astype(np.float32) + dp._normal(k_err, counts.shape, sigma,
                                                  torch.float32, "cpu").numpy()


@pytest.mark.parametrize("eps,chunk", [(8.0, None), (2.0, None), (8.0, 64)],
                         ids=["eps8", "eps2", "eps8 chunked"])
def test_fit_dp_matches_the_reference(eps, chunk):
    spec = PrivacySpec(epsilon=eps)
    jm = _ref_fit(eps, chunk, 3)
    tm = dp.fit_dp(_tcfg(), _data()[0], threefry.PRNGKey(3), spec, chunk_samples=chunk,
                   device="cpu")
    assert tm.weights[0].device.type == "cpu"
    assert_models_match(jm, tm._replace(train_errors=torch.from_numpy(
        np.asarray(jm.train_errors))), _ridge_last(_tcfg(), spec))
    _pool_match(tm.train_errors, jm.train_errors,
                _release_counts(_tcfg(), tm, _data()[0], spec, threefry.PRNGKey(3)))


def test_fit_dp_is_keyed_and_reproducible():
    spec = PrivacySpec(epsilon=4.0)
    x = _data()[1]
    a = dp.fit_dp(_tcfg(), x, threefry.PRNGKey(5), spec, device="cpu")
    b = dp.fit_dp(_tcfg(), x, threefry.PRNGKey(5), spec, device="cpu")
    c = dp.fit_dp(_tcfg(), x, threefry.PRNGKey(6), spec, device="cpu")
    assert all(torch.equal(wa, wb) for wa, wb in zip(a.weights, b.weights))
    assert any(not torch.equal(wa, wc) for wa, wc in zip(a.weights, c.weights))


def test_fit_dp_fused_backend_matches_einsum_on_the_host():
    """The fused backend's fold (the B3 kernel on the card, its plain
    version here) releases the same blocks as the einsum fold."""
    spec = PrivacySpec(epsilon=8.0)
    x = _data()[1]
    a = dp.fit_dp(_tcfg(), x, threefry.PRNGKey(2), spec, device="cpu")
    b = dp.fit_dp(_tcfg(stats_backend="fused"), x, threefry.PRNGKey(2), spec, device="cpu")
    for ka, kb in zip(a.layer_knowledge, b.layer_knowledge, strict=True):
        assert_close(kb.g, ka.g, atol=1e-5 * float(ka.g.abs().max()), rtol=1e-5)
        assert_close(kb.m, ka.m, atol=1e-5 * float(ka.m.abs().max()), rtol=1e-5)


def test_clip_columns_and_validation_match_the_reference():
    x = np.random.default_rng(0).normal(size=(M0, 30)).astype(np.float32) * 10
    for clip in (1.0, 0.25):
        assert_close(dp.clip_columns(x, clip), jdp.clip_columns(jnp.asarray(x), clip))
    small = np.full((M0, 3), 0.01, np.float32)
    np.testing.assert_array_equal(dp.clip_columns(small, 1.0).numpy(), small)
    cases = [(dict(), dict(secagg=True)), (dict(method="svd"), dict(epsilon=1.0)),
             (dict(act_hidden="tanh"), dict(epsilon=1.0))]
    for cfg_kw, spec_kw in cases:
        with pytest.raises(PrivacyError) as terr:
            dp.fit_dp(_tcfg(**cfg_kw), _data()[0], threefry.PRNGKey(0),
                      PrivacySpec(**spec_kw), device="cpu")
        with pytest.raises(JPrivacyError) as jerr:
            jdp.fit_dp(_jcfg(**cfg_kw), _data()[0], jax.random.PRNGKey(0), JSpec(**spec_kw))
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="input dim"):
        dp.fit_dp(_tcfg(), _data()[0][:-1], threefry.PRNGKey(0), PrivacySpec(epsilon=1.0),
                  device="cpu")


def test_threat_demo_matches_the_reference():
    for n in (4, 8):
        t, j = threat.demo(n_features=n), jthreat.demo(n_features=n)
        assert t["relative_error"] == j["relative_error"] < 1e-6
        np.testing.assert_array_equal(t["reconstruction"], j["reconstruction"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=8)
    x /= np.linalg.norm(x)
    g = np.outer(x, x)
    sigma = dp.calibrate_sigma(1.0, 1e-5)
    noised = dp._sym_noise(threefry.PRNGKey(0), (8, 8), sigma, torch.float64) + torch.from_numpy(g)
    want = np.asarray(jdp._sym_noise(jax.random.PRNGKey(0), (8, 8), sigma, jnp.float64)) + g
    np.testing.assert_array_equal(noised.numpy(), want)
    assert threat.reconstruction_error(x, noised) == jthreat.reconstruction_error(x, want)
    assert threat.reconstruction_error(x, noised) > 10 * threat.reconstruction_error(x, g)


# ---------------------------------------------------------------------------
# The session's DP rounds (TestSessionDP)
# ---------------------------------------------------------------------------

def _sessions(**plan):
    spec = plan.pop("spec")
    jeng = JEngine(_jcfg(), JPlan(**plan, privacy=JSpec(**spec)))
    teng = DAEFEngine(_tcfg(), ExecutionPlan(**plan, privacy=PrivacySpec(**spec)), device="cpu")
    return jeng, teng


def _assert_dp_models_match(jm, tm):
    """A session's DP model: its weights are re-solved from the released
    knowledge at the config's λ (the ridge is the release's own solve)."""
    assert_models_match(jm, tm._replace(train_errors=torch.from_numpy(
        np.asarray(jm.train_errors))), LAM_L)
    # each pooled error is one of the release's bin centres, as the reference's
    centres = (np.arange(dp.ERR_BINS) + 0.5) * dp.ERR_CAP / dp.ERR_BINS
    assert np.isin(to_np(tm.train_errors), centres.astype(np.float32)).all()
    assert tm.train_errors.shape == jm.train_errors.shape


def test_engine_constructs_with_a_dp_plan():
    for plan in (dict(merge="pairwise"), dict(federation="async", merge="sequential"),
                 dict(federation="async", merge="pairwise")):
        eng = DAEFEngine(_tcfg(), ExecutionPlan(**plan, privacy=PrivacySpec(epsilon=8.0)),
                         device="cpu")
        assert eng.plan.privacy.dp_enabled
    with pytest.raises(PlanError, match="logsig"):
        DAEFEngine(_tcfg(act_hidden="tanh"),
                   ExecutionPlan(merge="pairwise", privacy=PrivacySpec(epsilon=1.0)),
                   device="cpu")


def test_dp_round_spends_and_matches_the_reference():
    spec = dict(epsilon=8.0)
    jeng, teng = _sessions(merge="pairwise", spec=spec)
    js, ts = jeng.session(), teng.session()
    parts = list(_data())
    jm = js.round([jnp.asarray(p) for p in parts])
    tm = ts.round(parts)
    _assert_dp_models_match(jm, tm)
    for site in range(len(parts)):
        assert ts.privacy_spent(site) == js.privacy_spent(site)
        assert ts.privacy_spent(site)[0] == pytest.approx(8.0)
    plain = DAEFEngine(_tcfg(), ExecutionPlan(merge="pairwise"), device="cpu")
    pm = plain.session().round(parts)
    assert any(not torch.allclose(a, b) for a, b in zip(tm.weights, pm.weights))


def test_budget_refusal_aborts_round_before_any_draw(monkeypatch):
    spec = dict(epsilon=4.0, budget_epsilon=9.0, composition="basic")
    _, teng = _sessions(merge="pairwise", spec=spec)
    s = teng.session()
    parts = list(_data())
    s.round(parts)
    s.round(parts)
    draws = []
    real = threefry.normal
    monkeypatch.setattr(threefry, "normal", lambda *a, **k: draws.append(1) or real(*a, **k))
    with pytest.raises(PrivacyBudgetExceeded) as terr:
        s.round(parts)
    assert not draws and s.rounds_run == 2
    assert s.privacy_spent(0) == (8.0, 2e-5)  # still the two rounds
    # the reference's refusal says the same
    jl = JEngine(_jcfg(), JPlan(merge="pairwise", privacy=JSpec(**spec))).session()
    jl._ledger_for(0).spend(4.0, 1e-5)
    jl._ledger_for(0).spend(4.0, 1e-5)
    with pytest.raises(JBudgetExceeded) as jerr:
        jl._ledger_for(0).spend(4.0, 1e-5)
    assert str(terr.value) == str(jerr.value)


def test_async_dp_rounds_match_the_reference_and_persist(tmp_path):
    spec = dict(epsilon=8.0, budget_epsilon=100.0)
    jeng, teng = _sessions(federation="async", merge="pairwise", spec=spec)
    js, ts = jeng.session(), teng.session()
    a, b = _data()
    half = a.shape[1] // 2
    rounds = [{"a": a[:, :half], "b": b}, [("a", a[:, half:]), ("a", a[:, :half])]]
    for parts in rounds:
        jparts = ({k: jnp.asarray(v) for k, v in parts.items()} if isinstance(parts, dict)
                  else [(k, jnp.asarray(v)) for k, v in parts])
        jm, tm = js.round(jparts), ts.round(parts)
        _assert_dp_models_match(jm, tm)
    assert ts.privacy_spent("a") == js.privacy_spent("a")
    assert ts.privacy_spent("b") == js.privacy_spent("b")
    assert ts._ledger["a"].submits == 3
    # same data, a new round: fresh noise lands in the ledger
    g_before = ts._ledger["b"].state[1][0].g.clone()
    path = teng.save(ts, str(tmp_path / "sess"))
    ts2 = teng.load(path)
    assert (ts2.clock, ts2.rounds_run, ts2.sites) == (ts.clock, ts.rounds_run, ts.sites)
    assert ts2.privacy_spent("a") == ts.privacy_spent("a")
    ma, mb = ts.round({"b": b}), ts2.round({"b": b})
    for x, y in zip(ma.weights, mb.weights, strict=True):
        assert torch.equal(x, y)
    assert not torch.equal(ts._ledger["b"].state[1][0].g, g_before)
    assert ts.privacy_spent("b")[0] > js.privacy_spent("b")[0]


def test_reference_dp_session_restores_in_the_port(tmp_path):
    """A reference DP session (its ledger holding noised releases) restores
    in a port engine under the same spec, and its next DP round draws the
    reference's noise."""
    spec = dict(epsilon=8.0)
    jeng, teng = _sessions(federation="async", merge="pairwise", spec=spec)
    js = jeng.session()
    a, b = _data()
    js.round({"a": jnp.asarray(a)})
    path = jeng.save(js, str(tmp_path / "ref"))
    ts = teng.load(path)
    assert ts.privacy_spent("a") == js.privacy_spent("a")
    jm, tm = js.round({"b": jnp.asarray(b)}), ts.round({"b": b})
    _assert_dp_models_match(jm, tm)
