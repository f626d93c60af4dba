"""repro_torch.core.rolann and elm_ae.train_layer against the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close, lowrank_data

from repro.core import activations as jact
from repro.core import daef as jdaef
from repro.core import elm_ae as jelm
from repro.core import rolann as jrol
from repro_torch.core import activations as tact
from repro_torch.core import daef as tdaef
from repro_torch.core import elm_ae as telm
from repro_torch.core import rolann as trol


def _layer_data(act, m=9, o=6, n=700, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(m, n)).astype(np.float32)
    if act == "logsig":
        d = rng.uniform(0.0, 1.0, size=(o, n))
        d[0, :5] = [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5]  # saturated targets get clipped
    elif act == "tanh":
        d = rng.uniform(-1.0, 1.0, size=(o, n))
    else:
        d = rng.normal(size=(o, n))
    return x, d.astype(np.float32)


@pytest.mark.parametrize("act", ["logsig", "tanh", "linear"])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_compute_stats(act, backend):
    x, d = _layer_data(act)
    got = trol.compute_stats(torch.from_numpy(x), torch.from_numpy(d), tact.get(act),
                             backend=backend)
    want = jrol.compute_stats(jnp.asarray(x), jnp.asarray(d), jact.get(act),
                              backend=backend)
    assert got.shared_f == want.shared_f == (act == "linear")
    assert tuple(got.g.shape) == want.g.shape and tuple(got.m.shape) == want.m.shape
    assert_sum_close(got.g, want.g)
    assert_sum_close(got.m, want.m)


def _stats_from_reference(act="logsig", seed=0):
    x, d = _layer_data(act, seed=seed)
    want = jrol.compute_stats(jnp.asarray(x), jnp.asarray(d), jact.get(act))
    tstats = trol.RolannStats(g=torch.from_numpy(np.array(want.g)),
                              m=torch.from_numpy(np.array(want.m)))
    return tstats, want


@pytest.mark.parametrize("solver", ["chol", "eigh", "auto"])
@pytest.mark.parametrize("act", ["logsig", "linear"])
def test_solve_routes(solver, act):
    """The same statistics solve to the same weights on every route."""
    tstats, jstats = _stats_from_reference(act)
    w, b = trol.solve(tstats, 0.3, gram_solver=solver)
    wj, bj = jrol.solve(jstats, 0.3, gram_solver=solver)
    assert_close(w, wj)
    assert_close(b, bj)


def _non_pd_stats():
    """Per-output G with a negative eigenvalue larger than lam in one output:
    its Cholesky fails, as a float32 Gram with lam tiny against ||G|| can."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(5, 5)))
    evals = np.array([[4.0, 3.0, 2.0, 1.0, 0.5], [4.0, 3.0, 2.0, 1.0, -0.5]])
    g = np.einsum("ij,oj,kj->oik", q, evals, q).astype(np.float32)
    m = rng.normal(size=(2, 5)).astype(np.float32)
    return g, m


def test_solve_non_pd_takes_the_eigh_rescue():
    g, m = _non_pd_stats()
    tstats = trol.RolannStats(g=torch.from_numpy(g), m=torch.from_numpy(m))
    jstats = jrol.RolannStats(g=jnp.asarray(g), m=jnp.asarray(m))
    lam = 0.01
    # chol alone: NaN weights for the failed output, as in the reference
    w_chol, _ = trol.solve(tstats, lam, gram_solver="chol")
    wj_chol, _ = jrol.solve(jstats, lam, gram_solver="chol")
    assert np.isnan(w_chol.numpy()[:, 1]).all() and np.isnan(np.asarray(wj_chol)[:, 1]).all()
    assert_close(w_chol[:, 0], wj_chol[:, 0])
    # auto: the eigh route (negative eigenvalue clipped to 0) for all outputs
    w, b = trol.solve(tstats, lam, gram_solver="auto")
    wj, bj = jrol.solve(jstats, lam, gram_solver="auto")
    assert np.isfinite(w.numpy()).all()
    assert_close(w, wj)
    assert_close(b, bj)
    w_e, b_e = trol.solve(tstats, lam, gram_solver="eigh")
    assert_close(w, w_e)
    assert_close(b, b_e)


def test_solve_shared_non_pd_is_nan_under_chol():
    g, m = _non_pd_stats()
    tstats = trol.RolannStats(g=torch.from_numpy(g[1]), m=torch.from_numpy(m))
    w, _ = trol.solve(tstats, 0.01, gram_solver="chol")
    assert np.isnan(w.numpy()).all()
    w, b = trol.solve(tstats, 0.01, gram_solver="auto")
    wj, bj = jrol.solve(jrol.RolannStats(g=jnp.asarray(g[1]), m=jnp.asarray(m)), 0.01,
                        gram_solver="auto")
    assert_close(w, wj)
    assert_close(b, bj)


def test_stats_to_factors_descending():
    tstats, jstats = _stats_from_reference()
    f = trol.stats_to_factors(tstats)
    fj = jrol.stats_to_factors(jstats)
    assert np.all(np.diff(f.s.numpy(), axis=-1) <= 0)
    assert_close(f.s, fj.s, atol=1e-4, rtol=1e-3)
    # U S^2 U^T gives G back
    g = torch.einsum("oir,or,ojr->oij", f.u, f.s**2, f.u)
    assert_sum_close(g, tstats.g)


def test_fit_and_predict():
    x, d = _layer_data("tanh")
    w, b, k = trol.fit(torch.from_numpy(x), torch.from_numpy(d), tact.tanh, 0.2)
    wj, bj, kj = jrol.fit(jnp.asarray(x), jnp.asarray(d), jact.tanh, 0.2)
    assert_close(w, wj)
    assert_close(b, bj)
    assert_close(trol.predict(torch.from_numpy(x), w, b, tact.tanh),
                 jrol.predict(jnp.asarray(x), wj, bj, jact.tanh))
    with pytest.raises(NotImplementedError, match="queue A"):
        trol.fit(torch.from_numpy(x), torch.from_numpy(d), tact.tanh, 0.2, method="svd")
    with pytest.raises(ValueError, match="unknown gram_solver"):
        trol.solve(k, 0.2, gram_solver="lu")


@pytest.mark.parametrize("init", ["xavier", "random", "orthogonal"])
@pytest.mark.parametrize("aux_bias", ["zero", "c1"])
def test_train_layer(init, aux_bias):
    """Alg. 2 on one decoder layer: stage-1 draw, ROLANN solve, next layer."""
    h = 1.0 / (1.0 + np.exp(-lowrank_data(6, 3, 600, seed=2)))
    key = tdaef.layer_keys_from_seed(0, 5)[2]
    jkey = jdaef.layer_keys_from_seed(0, 5)[2]
    got = telm.train_layer(key, torch.from_numpy(h), 8, 0.5, tact.logsig, init=init,
                           aux_bias=aux_bias)
    want = jelm.train_layer(jkey, jnp.asarray(h), 8, 0.5, jact.logsig, init=init,
                            aux_bias=aux_bias)
    assert_close(got.w, want.w)
    assert_close(got.b, want.b)
    assert_close(got.h, want.h)
    assert_sum_close(got.knowledge.g, want.knowledge.g)
    assert_sum_close(got.knowledge.m, want.knowledge.m)
