"""repro_torch.core.fleet against repro.core.fleet (the tenant fleet).

The same numpy data go through the reference's fleet (einsum backend; its
fused backend interprets Pallas on the CPU, too slow for tier-1) and the
port's, on both of the port's backends (the fused one through the kernels'
plain versions).  K = 4 tenants of test_torch_daef.py's 10-4-6-8-10 net,
n = 240 samples each (test_torch_streaming.py's N: at n = 96 the last
layer is nearly degenerate, max|W| ~ 5e-3, and the port's own one-tenant fit
differs from the reference there by more than the κ bar — a property of the
data, not of the fleet).  Seeds [0, 0, 3, 3] and lam_hidden [0.5, 0.5, 0.7,
0.7]: two sites of two devices, adjacent tenants sharing a seed and lambdas
so that they merge.

Which reference the port matches (ROADMAP's rule for queue A item 8): every
tenant of the port's fleet is held by ``assert_models_match`` (TOLS, sums at
1e-4 × their max, the encoder as U S² Uᵀ, the last layer at the κ bar) both
to the reference's loop (``repro.core.daef.fit`` of that tenant, with its
seed and lambdas) and to its vmap (``repro.core.fleet._fit_fleet``), and
matches both: on these data the reference's loop and vmap agree with each
other to float32 rounding on the CPU (test_the_references_agree).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, assert_sum_close, lowrank_data

from repro.core import daef as jdaef
from repro.core import fleet as jfleet
from repro_torch import interop
from repro_torch.core import daef as tdaef
from repro_torch.core import fleet as tfleet

K, M0, LATENT, N = 4, 10, 4, 240
LAYERS = (M0, LATENT, 6, 8, M0)
SEEDS = np.array([0, 0, 3, 3], np.int32)
LAM_HIDDEN = np.array([0.5, 0.5, 0.7, 0.7], np.float32)
LAM_LAST = 0.9
BACKENDS = ["einsum", "fused"]
PER_TENANT = dict(seeds=SEEDS, lam_hidden=LAM_HIDDEN, lam_last=LAM_LAST)


def _kw(**kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST), **kw)


def _tcfg(backend="einsum", **kw):
    return tdaef.DAEFConfig(**_kw(stats_backend=backend, **kw))


def _jcfg(**kw):
    return jdaef.DAEFConfig(**_kw(stats_backend="einsum", **kw))


@functools.lru_cache(maxsize=None)
def _data(n: int = N, seed: int = 0, unit: bool = False) -> np.ndarray:
    xs = np.stack([lowrank_data(M0, LATENT, n, seed=seed + t) for t in range(K)])
    if unit:  # rescaled into [0, 1] per tenant and feature, for a logistic output
        lo, hi = xs.min(axis=2, keepdims=True), xs.max(axis=2, keepdims=True)
        xs = ((xs - lo) / (hi - lo)).astype(np.float32)
    xs.flags.writeable = False
    return xs


def _jper_tenant():
    return dict(seeds=jnp.asarray(SEEDS), lam_hidden=jnp.asarray(LAM_HIDDEN),
                lam_last=LAM_LAST)


@functools.lru_cache(maxsize=None)
def _reference_fleet(seed: int = 0):
    return jfleet._fit_fleet(_jcfg(), jnp.asarray(_data(seed=seed)), **_jper_tenant())


@functools.lru_cache(maxsize=None)
def _reference_chunked(chunk: int, unit: bool = False, **kw):
    return jfleet._fit_fleet_chunked(_jcfg(**kw), jnp.asarray(_data(unit=unit)),
                                     chunk_samples=chunk, **_jper_tenant())


def _tenant(fleet, i):
    if isinstance(fleet, tfleet.DAEFFleet):
        return tfleet.get_model(fleet, i)
    return jax.tree.map(lambda leaf: leaf[i], fleet.model)


def _assert_fleets_match(jf, tf, *, s_as_sum=False):
    assert tf.size == jf.size
    np.testing.assert_array_equal(tf.seeds.numpy(), np.asarray(jf.seeds))
    assert tf.seeds.dtype == torch.int32
    assert_close(tf.lam_hidden, jf.lam_hidden)
    assert_close(tf.lam_last, jf.lam_last)
    for i in range(tf.size):
        assert_models_match(_tenant(jf, i), _tenant(tf, i), LAM_LAST, s_as_sum=s_as_sum)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_fleet_matches_the_loop_and_the_vmap_references(backend):
    xs = _data()
    tf = tfleet._fit_fleet(_tcfg(backend), xs, **PER_TENANT, device="cpu")
    assert tuple(tf.model.train_errors.shape) == (K, N)
    assert [tuple(w.shape) for w in tf.model.weights] == [
        (K, *w.shape[1:]) for w in _reference_fleet().model.weights]
    _assert_fleets_match(_reference_fleet(), tf)
    for i in range(K):  # the loop reference: one daef.fit per tenant
        assert_models_match(_loop_reference(i), _tenant(tf, i), LAM_LAST)
    # the public entry point itself (no engine in the port yet: not a shim)
    public = tfleet.fleet_fit(_tcfg(backend), torch.from_numpy(np.array(xs)),  # repro-lint: disable=RPR001
                              **PER_TENANT, device="cpu")
    for a, b in zip(tfleet._tree_leaves(public), tfleet._tree_leaves(tf)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _loop_reference(i: int):
    jcfg = _jcfg(seed=int(SEEDS[i]), lam_hidden=float(LAM_HIDDEN[i]))
    return jdaef.fit(jcfg, jnp.asarray(_data()[i]))


def test_the_references_agree():
    """The reference's vmap and loop fits agree to float32 rounding here
    (weights bit for bit, train errors within an ulp or two: 1e-6 relative
    holds them), so the port matching one at TOLS matches the other."""
    jf = _reference_fleet()
    for i in range(K):
        for a, b in zip(jax.tree.flatten(_tenant(jf, i))[0],
                        jax.tree.flatten(_loop_reference(i))[0]):
            b = np.asarray(b)
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6,
                                       atol=1e-6 * max(1.0, float(np.abs(b).max())))


def test_fleet_equals_the_ports_one_tenant_fits():
    xs = _data()
    tf = tfleet._fit_fleet(_tcfg(), xs, **PER_TENANT, n_partitions=3, device="cpu")
    for i in range(K):
        cfg = _tcfg(seed=int(SEEDS[i]), lam_hidden=float(LAM_HIDDEN[i]))
        one = tdaef.fit(cfg, xs[i], n_partitions=3, device="cpu")
        got = tfleet.get_model(tf, i)
        for a, b in zip(tfleet._tree_leaves(got), tfleet._tree_leaves(one)):
            assert_close(a, b)


def test_predict_scores_thresholds_classify():
    jf = _reference_fleet()
    tf = tfleet._fit_fleet(_tcfg(), _data(), **PER_TENANT, device="cpu")
    x_test = _data(n=50, seed=10)
    jcfg, tcfg = _jcfg(), _tcfg()
    assert_close(tfleet.fleet_predict(tcfg, tf, x_test, device="cpu"),
                 jfleet.fleet_predict(jcfg, jf, jnp.asarray(x_test)))
    n_valid = np.array([50, 31, 1, 0])
    ts = tfleet.fleet_scores(tcfg, tf, x_test, n_valid, device="cpu")
    js = jfleet.fleet_scores(jcfg, jf, jnp.asarray(x_test), jnp.asarray(n_valid))
    np.testing.assert_array_equal(np.isnan(ts.numpy()), np.isnan(np.asarray(js)))
    assert_close(ts, js)
    assert_close(tfleet.fleet_scores(tcfg, tf, x_test, device="cpu"),
                 jfleet.fleet_scores(jcfg, jf, jnp.asarray(x_test)))
    for rule in ("extreme_iqr", "q90"):
        tmu, jmu = tfleet.fleet_thresholds(tf, rule), jfleet.fleet_thresholds(jf, rule)
        assert tuple(tmu.shape) == (K,)
        assert_close(tmu, jmu)
    pred = tfleet.fleet_classify(ts, tmu, device="cpu")
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred[np.isnan(ts.numpy())].numpy(), 0)  # padding is normal
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jfleet.fleet_classify(ts.numpy(),
                                                                                 tmu.numpy())))


@pytest.mark.parametrize("backend", BACKENDS)
def test_merges_match_the_reference(backend):
    """fleet_merge_pairwise (64 -> 32 in the cell; 4 -> 2 here), fleet_merge
    of two fleets, and each merged tenant against the port's one-tenant
    merge_models of the same two models."""
    tcfg, jcfg = _tcfg(backend), _jcfg()
    tf = tfleet._fit_fleet(tcfg, _data(), **PER_TENANT, device="cpu")
    jp = jfleet.fleet_merge_pairwise(jcfg, _reference_fleet())
    tp = tfleet.fleet_merge_pairwise(tcfg, tf)
    assert tp.size == 2 and tuple(tp.model.train_errors.shape) == (2, 2 * N)
    _assert_fleets_match(jp, tp)
    for s in range(2):
        cfg = dataclasses.replace(tcfg, seed=int(SEEDS[2 * s]),
                                  lam_hidden=float(LAM_HIDDEN[2 * s]))
        one = tdaef.merge_models(cfg, tfleet.get_model(tf, 2 * s), tfleet.get_model(tf, 2 * s + 1))
        for a, b in zip(tfleet._tree_leaves(tfleet.get_model(tp, s)), tfleet._tree_leaves(one)):
            assert_close(a, b)
    tf2 = tfleet._fit_fleet(tcfg, _data(seed=20), **PER_TENANT, device="cpu")
    jf2 = jfleet._fit_fleet(jcfg, jnp.asarray(_data(seed=20)), **_jper_tenant())
    _assert_fleets_match(jfleet.fleet_merge(jcfg, _reference_fleet(), jf2),
                         tfleet.fleet_merge(tcfg, tf, tf2))
    unchecked = tfleet.fleet_merge_unchecked(tcfg, tf, tf2)
    assert torch.equal(unchecked.model.weights[-1], tfleet.fleet_merge(tcfg, tf, tf2).model.weights[-1])


def test_partial_fit_matches_the_reference():
    tcfg, jcfg = _tcfg(), _jcfg()
    tf = tfleet._fit_fleet(tcfg, _data(), **PER_TENANT, device="cpu")
    got = tfleet.fleet_partial_fit(tcfg, tf, _data(seed=20), device="cpu")
    want = jfleet.fleet_partial_fit(jcfg, _reference_fleet(), jnp.asarray(_data(seed=20)))
    _assert_fleets_match(want, got)


def test_fleet_from_models_and_get_model():
    tcfg = _tcfg()
    models = [tdaef.fit(tcfg, _data()[i], device="cpu") for i in range(3)]
    fl = tfleet.fleet_from_models(tcfg, models, lam_hidden=[0.1, 0.2, 0.3])
    jf = jfleet.fleet_from_models(_jcfg(), [jax.tree.map(jnp.asarray, _tenant(_reference_fleet(), i))
                                            for i in range(3)], lam_hidden=[0.1, 0.2, 0.3])
    assert fl.size == 3 and fl.seeds.dtype == torch.int32
    np.testing.assert_array_equal(fl.seeds.numpy(), np.asarray(jf.seeds))
    assert_close(fl.lam_hidden, jf.lam_hidden)
    assert_close(fl.lam_last, jf.lam_last)
    assert len(tfleet._tree_leaves(fl)) == len(jax.tree.flatten(jf)[0])
    for i, m in enumerate(models):
        for a, b in zip(tfleet._tree_leaves(tfleet.get_model(fl, i)), tfleet._tree_leaves(m)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [70, N])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_fleet_chunked_matches_the_reference(backend, chunk):
    """Chunks of 70 (3 × 70 + a ragged tail of 30, padded and masked) and
    of the whole n."""
    tf = tfleet._fit_fleet_chunked(_tcfg(backend), _data(), chunk_samples=chunk, **PER_TENANT,
                                   device="cpu")
    assert tuple(tf.model.train_errors.shape) == (K, N)
    _assert_fleets_match(_reference_chunked(chunk), tf)


def _chunks(xs, width):
    return [xs[:, :, i:i + width] for i in range(0, xs.shape[2], width)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_fleet_stream_source_kinds(backend):
    """A list, a one-shot generator (snapshotted) and a per-pass callable of
    [K, m0, 70] host chunks, the last one ragged, against the reference's
    streamed and chunked fleet fits; torch chunks are taken as they are."""
    xs = _data()
    want = jfleet._fit_fleet_stream(_jcfg(), _chunks(xs, 70), **_jper_tenant())
    cfg = _tcfg(backend)
    calls = []

    def as_callable():
        calls.append(1)
        return iter(_chunks(xs, 70))

    for src in (_chunks(xs, 70), iter(_chunks(xs, 70)), as_callable,
                [torch.from_numpy(np.array(c)) for c in _chunks(xs, 70)]):
        got = tfleet._fit_fleet_stream(cfg, src, **PER_TENANT, device="cpu", tenants=K)
        _assert_fleets_match(want, got)
        _assert_fleets_match(_reference_chunked(70), got)
    assert len(calls) == len(LAYERS)  # encoder, 2 hidden layers, last layer, errors


@pytest.mark.parametrize("backend", BACKENDS)
def test_logistic_output_chunked_fleet(backend):
    """A logistic last layer folds per-output statistics (the B5 route on the
    fused backend) against targets in [0, 1]; S held as S², as in
    tests/test_torch_streaming.py::test_act_last_logsig."""
    tf = tfleet._fit_fleet_chunked(_tcfg(backend, act_last="logsig"), _data(unit=True),
                                   chunk_samples=70, **PER_TENANT, device="cpu")
    assert tuple(tf.model.layer_knowledge[-1].g.shape) == (K, M0, LAYERS[-2] + 1, LAYERS[-2] + 1)
    _assert_fleets_match(_reference_chunked(70, True, act_last="logsig"), tf, s_as_sum=True)


class _Port:
    """The port's fleet entry points, asked for the CPU."""

    DAEFFleet = tfleet.DAEFFleet

    @staticmethod
    def fleet_fit(cfg, xs, **kw):
        return tfleet.fleet_fit(cfg, xs, device="cpu", **kw)  # repro-lint: disable=RPR001

    @staticmethod
    def _fit_fleet(cfg, xs, **kw):
        return tfleet._fit_fleet(cfg, xs, device="cpu", **kw)

    @staticmethod
    def _fit_fleet_stream(cfg, batches, **kw):
        return tfleet._fit_fleet_stream(cfg, batches, device="cpu", **kw)

    fleet_merge = staticmethod(tfleet.fleet_merge)
    fleet_merge_pairwise = staticmethod(tfleet.fleet_merge_pairwise)
    fleet_from_models = staticmethod(tfleet.fleet_from_models)


@pytest.mark.filterwarnings("ignore:fleet.fleet_fit is deprecated:DeprecationWarning")
def test_errors_match_the_reference():
    xs = np.array(_data())
    jcfg, tcfg = _jcfg(), _tcfg()
    jf, tf = _reference_fleet(), tfleet._fit_fleet(tcfg, xs, **PER_TENANT, device="cpu")

    def replace(fl, lib, **kw):
        return fl._replace(**{k: lib.asarray(v) if lib is jnp else torch.as_tensor(v)
                              for k, v in kw.items()})

    def three(fl, lib):
        if lib is jnp:
            return jax.tree.map(lambda leaf: leaf[:3], fl)
        return tfleet._tree_map(lambda leaf: leaf[:3].contiguous(), fl)

    bad = {
        "fleet data must be": lambda f, c, fl, lib: f.fleet_fit(c, xs[0]),  # repro-lint: disable=RPR001
        "fleet data must be ": lambda f, c, fl, lib: f._fit_fleet(c, xs[0]),
        "input dim": lambda f, c, fl, lib: f._fit_fleet(c, xs[:, :5]),
        "per-tenant value": lambda f, c, fl, lib: f._fit_fleet(c, xs, seeds=[1, 2]),
        "per-tenant value ": lambda f, c, fl, lib: f._fit_fleet(c, xs, lam_last=np.ones((2, 2))),
        "fleet sizes differ": lambda f, c, fl, lib: f.fleet_merge(c, fl, three(fl, lib)),
        "different per-tenant seeds": lambda f, c, fl, lib: f.fleet_merge(
            c, fl, replace(fl, lib, seeds=np.array([9, 9, 3, 3], np.int32))),
        "different per-tenant lambdas": lambda f, c, fl, lib: f.fleet_merge(
            c, fl, replace(fl, lib, lam_last=np.full(4, 0.5, np.float32))),
        "even fleet size": lambda f, c, fl, lib: f.fleet_merge_pairwise(c, three(fl, lib)),
        "empty model list": lambda f, c, fl, lib: f.fleet_from_models(c, []),
        "empty chunk stream": lambda f, c, fl, lib: f._fit_fleet_stream(c, []),
        "does not match": lambda f, c, fl, lib: f._fit_fleet_stream(c, [xs[0]]),
        "mid-stream": lambda f, c, fl, lib: f._fit_fleet_stream(
            c, [xs[..., :16], xs[..., 16:24], xs[..., 24:40]]),
        "tenant count changed": lambda f, c, fl, lib: f._fit_fleet_stream(
            c, [xs[..., :16], xs[:3, :, 16:32]]),
        "were expected": lambda f, c, fl, lib: f._fit_fleet_stream(c, [xs[..., :16]], tenants=3),
        "streaming fleet fit": lambda f, c, fl, lib: f._fit_fleet_stream(
            dataclasses.replace(c, method="svd"), [xs[..., :16]]),
    }
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match.strip()) as jerr:
            call(jfleet, jcfg, jf, jnp)
        with pytest.raises(ValueError, match=match.strip()) as terr:
            call(_Port, tcfg, tf, torch)
        assert str(terr.value) == str(jerr.value), match
    with pytest.raises(ValueError, match="chunked fleet fit"):
        tfleet._fit_fleet_chunked(dataclasses.replace(tcfg, method="svd"), xs, chunk_samples=8,
                                  device="cpu")
    with pytest.raises(ValueError, match="chunk_samples"):
        tfleet._fit_fleet_chunked(tcfg, xs, chunk_samples=0, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A"):
        tfleet._fit_fleet(dataclasses.replace(tcfg, method="svd"), xs, device="cpu")


def test_interop_both_directions():
    """A fleet crosses as the leaves of jax.tree.flatten(DAEFFleet): a JAX
    fleet scores in the port as in the reference, and the port's fleet
    flattens to the same leaves in the same order and dtypes."""
    jf = _reference_fleet()
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jf)[0]]
    tf = interop.fleet_from_numpy(_tcfg(), leaves, device="cpu")
    back = interop.fleet_to_numpy(tf)
    assert len(back) == len(leaves)
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    x_test = _data(n=50, seed=10)
    assert_close(tfleet.fleet_scores(_tcfg(), tf, x_test, device="cpu"),
                 jfleet.fleet_scores(_jcfg(), jf, jnp.asarray(x_test)))
    port = tfleet._fit_fleet(_tcfg(), _data(), **PER_TENANT, device="cpu")
    jax_side = jax.tree.unflatten(jax.tree.structure(jf),
                                  [jnp.asarray(a) for a in interop.fleet_to_numpy(port)])
    assert_sum_close(jfleet.fleet_thresholds(jax_side), tfleet.fleet_thresholds(port))
    with pytest.raises(ValueError, match="leaves for a fleet"):
        interop.fleet_from_numpy(_tcfg(), leaves[:-1], device="cpu")
