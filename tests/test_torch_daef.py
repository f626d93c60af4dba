"""repro_torch.core.daef end to end against repro.core.daef (Algorithm 1).

The same numpy data go through ``repro.core.daef.fit`` and
``repro_torch.core.daef.fit``; every model leaf, the train errors, the test
scores and the classification are compared.  Tolerances:

* ``TOLS`` float32 (atol = rtol = 1e-4) for the encoder and hidden decoder
  weights and biases, the singular values, the train errors and the scores;
* sums over samples (the per-layer G and M, and the encoder's U S² Uᵀ) at
  ``assert_sum_close``: atol 1e-4 × the leaf's largest entry, since their
  rounding error grows with the summed terms, not with each result;
* the last layer's W and b: the linear ROLANN solve ``(G + λI) w = m`` with
  ``G = [h; 1][h; 1]ᵀ`` has a condition number κ of 10³–10⁴ on these data
  (saturated logsig rows of h are nearly collinear with the bias row), so a
  perturbation of float32 size (eps = 2⁻²³) in h moves w by up to κ·eps
  relative.  The test computes κ from the reference's statistics and allows
  10·κ·eps × max|[W; b]|.  The reconstructions these weights produce are
  well conditioned and are held to ``TOLS``;
* the full encoder U is not compared column by column: its trailing columns
  are eigenvectors of the noise floor's near-equal eigenvalues, which float32
  does not determine.  Its leading ``latent`` columns are the encoder weights
  (``TOLS``) and U S² Uᵀ is compared whole.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, lowrank_data

from repro.core import anomaly as jan
from repro.core import daef as jdaef
from repro.data import synthetic
from repro_torch import interop
from repro_torch.core import anomaly as tan
from repro_torch.core import daef as tdaef


def _fit_both(kw, x, n_partitions):
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    jm = jdaef.fit(jcfg, jnp.asarray(x), n_partitions=n_partitions)
    tm = tdaef.fit(tcfg, x, n_partitions=n_partitions, device="cpu")
    return jcfg, tcfg, jm, tm


def _assert_classification_matches(jcfg, tcfg, jm, tm, x_test, truth, rule):
    je = jdaef.reconstruction_error(jcfg, jm, jnp.asarray(x_test))
    te = tdaef.reconstruction_error(tcfg, tm, x_test, device="cpu")
    assert te.dtype == torch.float32 and tuple(te.shape) == (x_test.shape[1],)
    assert_close(te, je, what="test scores")
    mu_t = tan.threshold(tm.train_errors, rule, device="cpu")
    mu_j = jan.threshold(jm.train_errors, rule)
    assert_close(mu_t, mu_j, what="threshold")
    # No score sits within TOLS of the threshold on these seeds, so the
    # labels, and every metric, must agree exactly.
    band = 1e-4 + 1e-4 * abs(float(mu_j))
    assert not np.any(np.abs(np.asarray(je) - float(mu_j)) <= band)
    np.testing.assert_array_equal(
        tan.classify(te, mu_t, device="cpu").numpy(), np.asarray(jan.classify(je, mu_j))
    )
    got = tan.evaluate(tm.train_errors, te, truth, rule, device="cpu")
    want = jan.evaluate(jm.train_errors, je, truth, rule)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("init", ["xavier", "random", "orthogonal"])
@pytest.mark.parametrize("n_partitions", [1, 4])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_fit_matches_reference(init, n_partitions, backend):
    layers, lam_hidden, lam_last = (10, 4, 6, 8, 10), 0.7, 0.9
    x = lowrank_data(10, 4, 800, seed=0)
    kw = dict(layer_sizes=layers, lam_hidden=lam_hidden, lam_last=lam_last, init=init,
              stats_backend=backend)
    jcfg, tcfg, jm, tm = _fit_both(kw, x, n_partitions)
    assert [tuple(w.shape) for w in tm.weights] == [w.shape for w in jm.weights]
    assert_models_match(jm, tm, lam_last)
    x_test = np.concatenate([lowrank_data(10, 4, 200, seed=1),
                             2.5 * np.random.default_rng(2).normal(size=(10, 40))], axis=1)
    truth = np.r_[np.zeros(200), np.ones(40)].astype(np.int32)
    _assert_classification_matches(jcfg, tcfg, jm, tm, x_test.astype(np.float32), truth,
                                   "q90")


@pytest.mark.parametrize("solver", ["eigh", "auto"])
def test_fit_gram_solvers(solver):
    kw = dict(layer_sizes=(8, 3, 5, 8), lam_hidden=0.5, lam_last=0.5, gram_solver=solver)
    x = lowrank_data(8, 3, 500, seed=3)
    _, _, jm, tm = _fit_both(kw, x, 1)
    assert_models_match(jm, tm, 0.5)


def test_paper_replica_fit_score_classify():
    """The quickstart's cardio replica (paper Table 5 DAEF architecture):
    fit with 4 partitions -> score -> extreme-IQR threshold -> classify."""
    x_train, x_test, truth = synthetic.make_dataset("cardio").train_test_split(0)
    kw = dict(layer_sizes=(21, 4, 8, 12, 16, 21), lam_hidden=0.9, lam_last=0.9)
    jcfg, tcfg, jm, tm = _fit_both(kw, x_train, 4)
    assert_models_match(jm, tm, 0.9)
    _assert_classification_matches(jcfg, tcfg, jm, tm, x_test, truth, "extreme_iqr")


def test_interop_scores_a_jax_fitted_model():
    """A model fitted by the JAX package, carried over as numpy leaves in
    jax.tree.flatten order, scores in the port as in the reference."""
    kw = dict(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9)
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    jm = jdaef.fit(jcfg, jnp.asarray(lowrank_data(10, 4, 600, seed=4)))
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jm)[0]]
    tm = interop.model_from_numpy(tcfg, leaves, device="cpu")
    for got, want in zip(interop.model_to_numpy(tm), leaves):
        np.testing.assert_array_equal(got, want)
    x_test = lowrank_data(10, 4, 300, seed=5)
    assert_close(tdaef.reconstruction_error(tcfg, tm, x_test, device="cpu"),
                 jdaef.reconstruction_error(jcfg, jm, jnp.asarray(x_test)))
    assert_close(tdaef.predict(tcfg, tm, x_test, device="cpu"),
                 jdaef.predict(jcfg, jm, jnp.asarray(x_test)))
    with pytest.raises(ValueError, match="expected 16 leaves"):
        interop.model_from_numpy(tcfg, leaves[:-1], device="cpu")


def test_config_validation_matches_reference():
    for bad in [dict(layer_sizes=(4, 2)), dict(layer_sizes=(4, 2, 5)),
                dict(layer_sizes=(4, 2, 4), stats_backend="pallas"),
                dict(layer_sizes=(4, 2, 4), gram_solver="lu")]:
        with pytest.raises(ValueError) as jerr:
            jdaef.DAEFConfig(**bad)
        with pytest.raises(ValueError) as terr:
            tdaef.DAEFConfig(**bad)
        assert str(terr.value) == str(jerr.value)
    t = tdaef.DAEFConfig(layer_sizes=(5, 2, 3, 5))
    j = jdaef.DAEFConfig(layer_sizes=(5, 2, 3, 5))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.latent_dim, t.n_decoder_hidden) == (j.latent_dim, j.n_decoder_hidden)
    np.testing.assert_array_equal(t.layer_keys().numpy(),
                                  np.asarray(j.layer_keys()).astype(np.int64))


def test_fit_rejects_what_is_not_ported():
    """A wrong input dimension is refused as the reference refuses it; the
    svd method, now ported, fits as the reference's does (scores at TOLS)."""
    x = lowrank_data(5, 2, 300, seed=11)
    kw = dict(layer_sizes=(5, 2, 5), method="svd")
    jm = jdaef.fit(jdaef.DAEFConfig(**kw), jnp.asarray(x))
    tm = tdaef.fit(tdaef.DAEFConfig(**kw), x, device="cpu")
    assert_close(tdaef.reconstruction_error(tdaef.DAEFConfig(**kw), tm, x, device="cpu"),
                 jdaef.reconstruction_error(jdaef.DAEFConfig(**kw), jm, jnp.asarray(x)))
    with pytest.raises(ValueError, match="input dim"):
        tdaef.fit(tdaef.DAEFConfig(layer_sizes=(5, 2, 5)), np.zeros((4, 10)), device="cpu")


def test_float64_fit_stays_float64():
    """float64 tensors in, float64 model out (float64 is allowed; the default
    is float32)."""
    x = torch.from_numpy(lowrank_data(6, 2, 300, seed=6)).double()
    cfg = tdaef.DAEFConfig(layer_sizes=(6, 2, 4, 6))
    m = tdaef.fit(cfg, x, device="cpu")
    assert all(w.dtype == torch.float64 for w in m.weights)
    assert tdaef.reconstruction_error(cfg, m, x, device="cpu").dtype == torch.float64
    m32 = tdaef.fit(cfg, x.numpy(), device="cpu")
    assert m32.train_errors.dtype == torch.float32
    assert_close(m32.train_errors, m.train_errors, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("seed", [5, 21])
def test_cancelling_last_layer_gap_is_float32_rounding(seed, monkeypatch):
    """On data whose last layer is nearly all regularizer (|W| ~5e-3), the
    port's and the reference's float32 fits differ by more than the κ bar
    (up to 1.7× of it on these seeds).  A float64 fit of the port, with the
    same stage-1 draws, is the exact answer that the reference's float64
    fit also gives (to ~5e-15, the classification of ROADMAP queue C): both
    float32 fits sit within ``cancellation_bar`` of it, and of each other."""
    from _torch_parity import EPS32, cancellation_bar
    from repro_torch.core import elm_ae

    kw = dict(layer_sizes=(9, 3, 5, 7, 9), lam_hidden=0.7, lam_last=0.9, seed=0)
    x = lowrank_data(9, 3, 120, seed=seed)
    _, _, jm, tm = _fit_both(kw, x, 1)
    draw = elm_ae._draw
    monkeypatch.setattr(elm_ae, "_draw", lambda key, m_in, m_out, init, dtype, device: tuple(
        a.to(dtype) for a in draw(key, m_in, m_out, init, torch.float32, device)))
    elm_ae._stage1_cached.cache_clear()
    exact = tdaef.fit(tdaef.DAEFConfig(**kw), torch.from_numpy(x).double(), device="cpu")
    elm_ae._stage1_cached.cache_clear()

    def last(m):
        return np.concatenate([np.asarray(m.weights[-1], np.float64),
                               np.asarray(m.biases[-1], np.float64)[None]])

    g = np.asarray(jm.layer_knowledge[-1].g, np.float64)
    kappa = float(np.linalg.cond(g + 0.9 * np.eye(g.shape[-1])))
    kappa_bar = 10 * kappa * EPS32 * float(np.abs(last(jm)).max())
    bar = cancellation_bar(jm, 0.9)
    assert np.abs(last(tm) - last(jm)).max() > kappa_bar
    for fit in (tm, jm):
        assert np.abs(last(fit) - last(exact)).max() <= bar
    assert_models_match(jm, tm, 0.9, m_cancels=True)


def _merge_data():
    kw = dict(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9, seed=3)
    x = lowrank_data(10, 4, 1_000, seed=9)
    return kw, x[:, :550], x[:, 550:]


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_merge_models_matches_reference(backend):
    """Two partitions' models merged (encoder factors by Eq. 2, (G, M) by
    sum, one re-solve) against repro.core.daef.merge_models, and
    merge_knowledge's pieces."""
    kw, xa, xb = _merge_data()
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw, stats_backend=backend)
    ja, jb = jdaef.fit(jcfg, jnp.asarray(xa)), jdaef.fit(jcfg, jnp.asarray(xb))
    ta, tb = tdaef.fit(tcfg, xa, device="cpu"), tdaef.fit(tcfg, xb, device="cpu")
    jm, tm = jdaef.merge_models(jcfg, ja, jb), tdaef.merge_models(tcfg, ta, tb)
    assert_models_match(jm, tm, 0.9)
    enc, knowledge, errors = tdaef.merge_knowledge(tcfg, ta, tb)
    assert torch.equal(errors, torch.cat([ta.train_errors, tb.train_errors]))
    for k, a, b in zip(knowledge, ta.layer_knowledge, tb.layer_knowledge):
        assert torch.equal(k.g, a.g + b.g) and torch.equal(k.m, a.m + b.m)
    assert torch.equal(enc.s, tm.encoder_factors.s)


def test_merge_models_takes_x_stats():
    """Both packages take the keyword ``x_stats`` and ignore it."""
    kw, xa, xb = _merge_data()
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    ja, jb = jdaef.fit(jcfg, jnp.asarray(xa)), jdaef.fit(jcfg, jnp.asarray(xb))
    ta, tb = tdaef.fit(tcfg, xa, device="cpu"), tdaef.fit(tcfg, xb, device="cpu")
    jm = jdaef.merge_models(jcfg, ja, jb, x_stats=jnp.asarray(xa))
    tm = tdaef.merge_models(tcfg, ta, tb, x_stats=torch.from_numpy(xa))
    assert_models_match(jm, tm, 0.9)
    plain = tdaef.merge_models(tcfg, ta, tb)
    for got, want in zip(tm.weights, plain.weights):
        assert torch.equal(got, want)


def test_partial_fit_matches_reference():
    kw, xa, xb = _merge_data()
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    jm = jdaef.partial_fit(jcfg, jdaef.fit(jcfg, jnp.asarray(xa)), jnp.asarray(xb))
    tm = tdaef.partial_fit(tcfg, tdaef.fit(tcfg, xa, device="cpu"), xb, device="cpu")
    assert_models_match(jm, tm, 0.9)
    assert tuple(tm.train_errors.shape) == (1_000,)


def test_merge_rejects_what_is_not_ported():
    """Merging svd models, now ported, gives the reference's merged model
    (scores at TOLS)."""
    kw, xa, xb = _merge_data()
    kw = dict(kw, method="svd")
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    jm = jdaef.merge_models(jcfg, jdaef.fit(jcfg, jnp.asarray(xa)), jdaef.fit(jcfg, jnp.asarray(xb)))
    tm = tdaef.merge_models(tcfg, tdaef.fit(tcfg, xa, device="cpu"),
                            tdaef.fit(tcfg, xb, device="cpu"))
    x_test = lowrank_data(10, 4, 200, seed=12)
    assert_close(tdaef.reconstruction_error(tcfg, tm, x_test, device="cpu"),
                 jdaef.reconstruction_error(jcfg, jm, jnp.asarray(x_test)))
