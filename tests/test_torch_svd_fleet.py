"""The tenant fleet with ``method="svd"`` against the reference
(``repro.core.fleet``), and the batched factor pieces it is built from.

The same numpy data as tests/test_torch_fleet.py: K = 4 tenants of the
10-4-6-8-10 net, n = 240 samples each, seeds [0, 0, 3, 3] and lam_hidden
[0.5, 0.5, 0.7, 0.7] (two sites of two devices).  Every tenant of the
port's svd fleet is held to both of the reference's fleets, its loop
(``repro.core.daef.fit`` of the tenant) and its vmap
(``repro.core.fleet._fit_fleet``), by tests/test_torch_svd.py's rule: each
layer's factors as U S² Uᵀ, S and M at ``assert_sum_close`` (1e-4 × the
leaf's largest entry), the weights at TOLS and the last layer at the κ bar.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close, lowrank_data
from test_torch_svd import assert_factors_match, assert_svd_models_match, factor_stats

from repro.core import daef as jdaef
from repro.core import fleet as jfleet
from repro_torch import interop
from repro_torch.core import activations as tact
from repro_torch.core import daef as tdaef
from repro_torch.core import elm_ae as telm
from repro_torch.core import fleet as tfleet
from repro_torch.core import rolann as trol

K, M0, LATENT, N = 4, 10, 4, 240
LAYERS = (M0, LATENT, 6, 8, M0)
SEEDS = np.array([0, 0, 3, 3], np.int32)
LAM_HIDDEN = np.array([0.5, 0.5, 0.7, 0.7], np.float32)
LAM_LAST = 0.9
KW = dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method="svd")
TCFG, JCFG = tdaef.DAEFConfig(**KW), jdaef.DAEFConfig(**KW)
PER_TENANT = dict(seeds=SEEDS, lam_hidden=LAM_HIDDEN, lam_last=LAM_LAST)


@functools.lru_cache(maxsize=None)
def _data(n: int = N, seed: int = 0) -> np.ndarray:
    xs = np.stack([lowrank_data(M0, LATENT, n, seed=seed + t) for t in range(K)])
    xs.flags.writeable = False
    return xs


def _jper_tenant():
    return dict(seeds=jnp.asarray(SEEDS), lam_hidden=jnp.asarray(LAM_HIDDEN),
                lam_last=LAM_LAST)


@functools.lru_cache(maxsize=None)
def _reference_fleet(seed: int = 0):
    return jfleet._fit_fleet(JCFG, jnp.asarray(_data(seed=seed)), **_jper_tenant())


@functools.lru_cache(maxsize=None)
def _port_fleet(seed: int = 0):
    return tfleet._fit_fleet(TCFG, np.array(_data(seed=seed)), **PER_TENANT, device="cpu")


def _tenant(fleet, i):
    if isinstance(fleet, tfleet.DAEFFleet):
        return tfleet.get_model(fleet, i)
    return jax.tree.map(lambda leaf: leaf[i], fleet.model)


def _assert_fleets_match(jf, tf):
    assert tf.size == jf.size
    np.testing.assert_array_equal(tf.seeds.numpy(), np.asarray(jf.seeds))
    assert_close(tf.lam_hidden, jf.lam_hidden)
    for i in range(tf.size):
        assert_svd_models_match(_tenant(jf, i), _tenant(tf, i), LAM_LAST)


def test_svd_fleet_matches_the_loop_and_the_vmap_references():
    """Mirrors tests/test_fleet.py's svd case: every tenant of the fleet
    against the reference's vmap fleet and its one-tenant fit."""
    tf = _port_fleet()
    assert all(isinstance(k, trol.RolannFactors) for k in tf.model.layer_knowledge)
    assert tuple(tf.model.layer_knowledge[0].u.shape) == (K, LATENT, 7, 7)
    _assert_fleets_match(_reference_fleet(), tf)
    for i in range(K):
        jcfg = dataclasses.replace(JCFG, seed=int(SEEDS[i]), lam_hidden=float(LAM_HIDDEN[i]))
        loop = jdaef.fit(jcfg, jnp.asarray(_data()[i]))
        assert_svd_models_match(loop, _tenant(tf, i), LAM_LAST)


def test_svd_fleet_equals_the_ports_one_tenant_fits():
    """The batched QRs and SVDs give each tenant its one-tenant svd fit
    (3 partitions: local SVDs merged by Eq. 2), leaf by leaf at TOLS, the
    factors as U S² Uᵀ and S at the sum bar."""
    xs = np.array(_data())
    tf = tfleet._fit_fleet(TCFG, xs, **PER_TENANT, n_partitions=3, device="cpu")
    for i in range(K):
        cfg = dataclasses.replace(TCFG, seed=int(SEEDS[i]), lam_hidden=float(LAM_HIDDEN[i]))
        one = tdaef.fit(cfg, xs[i], n_partitions=3, device="cpu")
        got = tfleet.get_model(tf, i)
        for a, b in zip(got.weights + got.biases, one.weights + one.biases, strict=True):
            assert_close(a, b)
        for kg, ko in zip(got.layer_knowledge, one.layer_knowledge, strict=True):
            assert_sum_close(factor_stats(kg).g, factor_stats(ko).g)
            assert_sum_close(kg.s, ko.s)
            assert_sum_close(kg.m, ko.m)
        assert_close(got.train_errors, one.train_errors)


def test_svd_fleet_merges_match_the_reference():
    """Mirrors tests/test_fleet.py's svd merge: fleet_merge_pairwise (4 -> 2)
    and fleet_merge of two fleets against the reference's, and each merged
    site against the port's one-tenant merge_models of its device pair."""
    tf = _port_fleet()
    tp = tfleet.fleet_merge_pairwise(TCFG, tf)
    assert tp.size == 2 and tuple(tp.model.train_errors.shape) == (2, 2 * N)
    _assert_fleets_match(jfleet.fleet_merge_pairwise(JCFG, _reference_fleet()), tp)
    for s in range(2):
        cfg = dataclasses.replace(TCFG, seed=int(SEEDS[2 * s]),
                                  lam_hidden=float(LAM_HIDDEN[2 * s]))
        one = tdaef.merge_models(cfg, tfleet.get_model(tf, 2 * s),
                                 tfleet.get_model(tf, 2 * s + 1))
        got = tfleet.get_model(tp, s)
        for a, b in zip(got.weights + got.biases, one.weights + one.biases, strict=True):
            assert_close(a, b)
        for kg, ko in zip(got.layer_knowledge, one.layer_knowledge, strict=True):
            assert_factors_match(kg, ko)
    merged = tfleet.fleet_merge(TCFG, tf, _port_fleet(20))
    want = jfleet.fleet_merge(JCFG, _reference_fleet(), _reference_fleet(20))
    _assert_fleets_match(want, merged)


def test_svd_fleet_scores_and_partial_fit_match_the_reference():
    x_test = np.array(_data(n=50, seed=10))
    assert_close(tfleet.fleet_scores(TCFG, _port_fleet(), x_test, device="cpu"),
                 jfleet.fleet_scores(JCFG, _reference_fleet(), jnp.asarray(x_test)))
    got = tfleet.fleet_partial_fit(TCFG, _port_fleet(), np.array(_data(seed=20)), device="cpu")
    want = jfleet.fleet_partial_fit(JCFG, _reference_fleet(), jnp.asarray(_data(seed=20)))
    _assert_fleets_match(want, got)


def test_svd_fleet_from_models_and_get_model():
    """One-tenant svd models stack into a fleet leaf by leaf (three leaves a
    layer, as jax.tree.flatten gives them) and come back unchanged."""
    models = [tdaef.fit(TCFG, np.array(_data()[i]), device="cpu") for i in range(3)]
    fl = tfleet.fleet_from_models(TCFG, models, lam_hidden=[0.1, 0.2, 0.3])
    jf = jfleet.fleet_from_models(JCFG, [_tenant(_reference_fleet(), i) for i in range(3)],
                                  lam_hidden=[0.1, 0.2, 0.3])
    assert fl.size == 3
    assert len(tfleet._tree_leaves(fl)) == len(jax.tree.flatten(jf)[0])
    for i, m in enumerate(models):
        for a, b in zip(tfleet._tree_leaves(tfleet.get_model(fl, i)), tfleet._tree_leaves(m)):
            assert torch.equal(a, b)


def test_svd_fleet_interop_both_directions():
    """An svd fleet crosses as the leaves of jax.tree.flatten(DAEFFleet): the
    reference's scores in the port as in the reference, and the port's
    flattens to the same leaves, order and dtypes."""
    jf = _reference_fleet()
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jf)[0]]
    tf = interop.fleet_from_numpy(TCFG, leaves, device="cpu")
    assert all(isinstance(k, trol.RolannFactors) for k in tf.model.layer_knowledge)
    back = interop.fleet_to_numpy(tf)
    assert len(back) == len(leaves)
    for got, want in zip(back, leaves, strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    x_test = np.array(_data(n=50, seed=10))
    assert_close(tfleet.fleet_scores(TCFG, tf, x_test, device="cpu"),
                 jfleet.fleet_scores(JCFG, jf, jnp.asarray(x_test)))
    ours = interop.fleet_to_numpy(_port_fleet())
    rebuilt = jax.tree.unflatten(jax.tree.flatten(jf)[1], [jnp.asarray(a) for a in ours])
    assert_close(jfleet.fleet_scores(JCFG, rebuilt, jnp.asarray(x_test)),
                 tfleet.fleet_scores(TCFG, _port_fleet(), x_test, device="cpu"))


@pytest.mark.parametrize("act", ["logsig", "linear"])
def test_batched_factors_equal_the_one_tenant_ones(act):
    """compute_factors_batched and train_layer_batched(method="svd") give
    each tenant its one-tenant factors and layer, and
    layer_from_knowledge_batched solves factors as layer_from_knowledge
    does (TOLS; factors as U S² Uᵀ, S, M at the sum bar)."""
    xs = np.array(_data(n=120))[:, :6]
    h = torch.sigmoid(torch.from_numpy(xs))
    d = h[:, :4] if act == "logsig" else torch.from_numpy(xs[:, :4])
    got = trol.compute_factors_batched(h, d, tact.get(act))
    for i in range(K):
        one = trol.compute_factors(h[i], d[i], tact.get(act))
        assert [tuple(a.shape[1:]) for a in got] == [tuple(a.shape) for a in one]
        assert_sum_close(factor_stats(trol.RolannFactors(*(a[i] for a in got))).g,
                         factor_stats(one).g)
        assert_sum_close(got.s[i], one.s)
        assert_close(got.m[i], one.m)
    keys = tdaef.layer_keys_from_seed(torch.from_numpy(SEEDS), 5)[:, 2]
    lams = torch.from_numpy(LAM_HIDDEN)
    res = telm.train_layer_batched(keys, h, 8, lams, tact.logsig, method="svd")
    w, b = telm.layer_from_knowledge_batched(res.knowledge, keys, 6, 8, lams, tact.logsig)
    assert torch.equal(w, res.w) and torch.equal(b, res.b)
    for i in range(K):
        one = telm.train_layer(keys[i], h[i], 8, float(LAM_HIDDEN[i]), tact.logsig,
                               method="svd")
        assert_close(res.w[i], one.w)
        assert_close(res.h[i], one.h)
        assert_sum_close(res.knowledge.s[i], one.knowledge.s)
    with pytest.raises(ValueError, match="unknown ROLANN method"):
        telm.train_layer_batched(keys, h, 8, lams, tact.logsig, method="qr")
