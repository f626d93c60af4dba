"""repro_torch.core.federated and the port's FederationSession against the
reference's (tests/test_federated.py and tests/test_async_federation.py;
the tree merges in tests/test_torch_mesh.py, and the async tree refresh
here).

* The layer-synchronised protocol (``_federated_fit``) equals the
  reference's on ragged partitions, both methods and both backends, and
  approaches the centralised fit as the reference's does; the broker
  protocol (``train_locally_and_aggregate``, ``broker_round``) equals the
  reference's; a published update's size and content.
* Async sessions: all sites every round with ``max_staleness=0`` equal the
  sequential broker merge of the same blocks, and the reference's session,
  in both modes and on both backends; empty and refresh-only rounds,
  staleness exclusion and delta replay, ``max_staleness``, a site joining
  mid-session, merge after reduce.
* The exchange states' merge (``merge_exchange_states``) and their additive
  wire form (``exchange_to_additive`` / ``additive_to_exchange``, the error
  histograms) against the reference's.

Models are held by ``assert_models_match`` (TOLS, sums at 1e-4 of their
max, the κ bar for the last layer); 9-3-5-7-9 nets, 2–4 sites of 60–200
samples.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, assert_sum_close, lowrank_data

from repro.core import daef as jdaef
from repro.core import federated as jfed
from repro.core import rolann as jrol
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.engine import PlanError as JPlanError
from repro_torch.core import daef as tdaef
from repro_torch.core import dsvd
from repro_torch.core import federated as tfed
from repro_torch.core import rolann as trol
from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError

M0, LATENT = 9, 3
LAYERS = (M0, LATENT, 5, 7, M0)
LAM_LAST = 0.9
MODES = ("loop", "vmap")


def _kw(method="gram", backend="einsum"):
    return dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method=method,
                stats_backend=backend)


def _tcfg(method="gram", backend="einsum"):
    return tdaef.DAEFConfig(**_kw(method, backend))


def _jcfg(method="gram"):
    return jdaef.DAEFConfig(**_kw(method))


def _engine(cfg=None, **plan):
    return DAEFEngine(cfg or _tcfg(), ExecutionPlan(**plan), device="cpu")


@functools.lru_cache(maxsize=None)
def _x(n=360, seed=0):
    x = lowrank_data(M0, LATENT, n, seed)
    x.flags.writeable = False
    return x


RAGGED = (0, 60, 120, 240, 360)  # four sites of 60, 60, 120 and 120 samples


def _ragged(seed=0):
    x = _x(seed=seed)
    return [x[:, a:b] for a, b in zip(RAGGED, RAGGED[1:])]


def _j(parts):
    return [jnp.asarray(p) for p in parts]


def _as_gram(model):
    if hasattr(model.layer_knowledge[0], "u"):
        lib = trol if isinstance(model, tdaef.DAEFModel) else jrol
        return model._replace(layer_knowledge=tuple(
            lib.factors_to_stats(k) for k in model.layer_knowledge))
    return model


def _match(jm, tm):
    assert_models_match(_as_gram(jm), _as_gram(tm), LAM_LAST)


# ---------------------------------------------------------------------------
# the layer-synchronised and the broker protocols
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jfederated(method):
    return jfed._federated_fit(_jcfg(method), _j(_ragged()))


@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("method", ["gram", "svd"])
def test_layer_synchronized_matches_the_reference(method, backend):
    tm = tfed._federated_fit(_tcfg(method, backend), _ragged(), device="cpu")
    _match(_jfederated(method), tm)
    assert tuple(tm.train_errors.shape) == (RAGGED[-1],)


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_layer_synchronized_equals_centralized(method):
    """As tests/test_federated.py: the federated model is the centralised
    one up to float error (weights within 3e-2, predictions within 1e-2),
    and so is the reference's federated model."""
    fed = tfed._federated_fit(_tcfg(method), _ragged(), device="cpu")
    cen = tdaef.fit(_tcfg(method), _x(), device="cpu")
    for a, b in zip(fed.weights, cen.weights, strict=True):
        assert_close(a, b, atol=3e-2, rtol=0)
    x_test = _x(n=120, seed=5)
    assert_close(tdaef.predict(_tcfg(method), fed, x_test, device="cpu"),
                 tdaef.predict(_tcfg(method), cen, x_test, device="cpu"), atol=1e-2, rtol=0)


def test_broker_protocol_matches_the_reference_and_is_reasonable():
    x = _x(n=240)
    parts = [x[:, i::4] for i in range(4)]
    agg = tfed.train_locally_and_aggregate(_tcfg(), parts, device="cpu")
    _match(jfed.train_locally_and_aggregate(_jcfg(), _j(parts)), agg)
    x_test = _x(n=120, seed=9)
    e_agg = float(tdaef.reconstruction_error(_tcfg(), agg, x_test, device="cpu").mean())
    e_cen = float(tdaef.reconstruction_error(
        _tcfg(), tdaef.fit(_tcfg(), x, device="cpu"), x_test, device="cpu").mean())
    assert np.isfinite(e_agg) and e_agg < 5 * e_cen + 0.5


def test_broker_round_matches_the_reference():
    parts = _ragged(seed=1)
    local_t = tdaef.fit(_tcfg(), parts[0], device="cpu")
    local_j = jdaef.fit(_jcfg(), jnp.asarray(parts[0]))
    ups_t = [tfed.publish(tdaef.fit(_tcfg(), p, device="cpu")) for p in parts[1:]]
    ups_j = [jfed.publish(jdaef.fit(_jcfg(), jnp.asarray(p))) for p in parts[1:]]
    got = tfed.broker_round(_tcfg(), local_t, ups_t)
    _match(jfed.broker_round(_jcfg(), local_j, ups_j), got)
    assert tuple(got.train_errors.shape) == (parts[0].shape[1],)


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_message_size_and_content(method):
    """Paper §5: the update's size does not grow with the local samples, is
    far smaller than the data, equals the reference's, and holds only small
    matrices whose dimensions come from the layer sizes."""
    small = tfed.publish(tdaef.fit(_tcfg(method), _x(n=60, seed=3), device="cpu"))
    large = tfed.publish(tdaef.fit(_tcfg(method), _x(seed=3), device="cpu"))
    ref = jfed.publish(jdaef.fit(_jcfg(method), jnp.asarray(_x(seed=3))))
    assert small.nbytes() == large.nbytes() == ref.nbytes()
    assert large.nbytes() < 0.25 * _x(seed=3).nbytes
    assert (small.n_samples, large.n_samples) == (60, 360)
    leaves = [*large.encoder_factors]
    for k in large.layer_knowledge:
        leaves.extend(k)
    for leaf in leaves:
        assert all(d <= M0 + 1 for d in leaf.shape), leaf.shape


# ---------------------------------------------------------------------------
# async sessions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _blocks(sites, rounds, n=60, seed=0):
    """Per-site per-round [M0, n] blocks from one generative process
    (tests/test_async_federation.py's)."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(M0, LATENT))

    def draw():
        z = np.tanh(rng.normal(size=(LATENT, n)))
        x = mix @ z + 0.1 * rng.normal(size=(M0, n))
        x = ((x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)).astype(np.float32)
        x.flags.writeable = False
        return x

    return tuple(tuple(draw() for _ in range(rounds)) for _ in range(sites))


def _reference(cfg, site_blocks):
    """The sequential broker merge of the same contributions, in the port:
    each site's per-round fits chained with merge_models, then reduced
    across sites."""
    site_models = []
    for blocks in site_blocks:
        m = tdaef.fit(cfg, blocks[0], device="cpu")
        for b in blocks[1:]:
            m = tdaef.merge_models(cfg, m, tdaef.fit(cfg, b, device="cpu"))
        site_models.append(m)
    out = site_models[0]
    for m in site_models[1:]:
        out = tdaef.merge_models(cfg, out, m)
    return out


@functools.lru_cache(maxsize=None)
def _jasync(merge, seed=0):
    plan = JPlan(federation="async", merge=merge)
    session = JEngine(_jcfg(), plan).session()
    for r in range(2):
        model = session.round(_j([b[r] for b in _blocks(3, 2, seed=seed)]))
    return model


@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_async_sync_parity(mode, backend):
    cfg = _tcfg(backend=backend)
    site_blocks = _blocks(3, 2)
    session = _engine(cfg, mode=mode, federation="async", merge="sequential").session()
    for r in range(2):
        model = session.round([blocks[r] for blocks in site_blocks])
    assert session.sites == {0: 0, 1: 0, 2: 0} and session.rounds_run == 2
    _match(_jasync("sequential"), model)
    ref = _reference(cfg, site_blocks)
    assert_models_match(ref, model, LAM_LAST)
    x = site_blocks[0][0]
    assert_close(tdaef.predict(cfg, model, x, device="cpu"),
                 tdaef.predict(cfg, ref, x, device="cpu"))


@pytest.mark.parametrize("merge", ["sequential", "pairwise"])
def test_async_merge_strategies_agree(merge):
    site_blocks = _blocks(3, 2, seed=1)
    session = _engine(federation="async", merge=merge).session()
    for r in range(2):
        model = session.round([b[r] for b in site_blocks])
    assert_models_match(_reference(_tcfg(), site_blocks), model, LAM_LAST)
    _match(_jasync(merge, seed=1), model)


def test_async_tree_refresh_raises_after_the_references_checks():
    parts = [b[0] for b in _blocks(2, 1)]
    with pytest.raises(JPlanError) as jerr:
        JEngine(_jcfg("svd"), JPlan(federation="async", merge="tree")).session().round(
            _j(parts))
    with pytest.raises(PlanError) as terr:
        _engine(_tcfg("svd"), federation="async", merge="tree").session().round(parts)
    assert str(terr.value) == str(jerr.value)
    # item 12's DAEF part is ported: the tree refresh runs and matches the
    # reference's, on these two sites and on three sites padded to four
    # slots (test_async_sync_parity's blocks); each site is its own draw, so
    # the last layers are held at the larger of the κ bar and
    # cancellation_bar (tests/_torch_parity.py)
    jsession = JEngine(_jcfg(), JPlan(federation="async", merge="tree")).session()
    session = _engine(federation="async", merge="tree").session()
    assert_models_match(jsession.round(_j(parts)), session.round(parts), LAM_LAST,
                        m_cancels=True)
    session = _engine(federation="async", merge="tree").session()
    for r in range(2):
        model = session.round([b[r] for b in _blocks(3, 2)])
    assert_models_match(_jasync("tree"), model, LAM_LAST, m_cancels=True)
    # one fresh site needs no reduction, tree or not
    model = _engine(federation="async", merge="tree").session().round({"a": parts[0]})
    assert_models_match(tdaef.fit(_tcfg(), parts[0], device="cpu"), model, LAM_LAST)


def test_sync_empty_round_raises():
    with pytest.raises(PlanError, match="async"):
        _engine().session().round([])


def test_async_empty_round_is_refresh_only():
    session = _engine(federation="async").session()
    assert session.round({}) is None
    assert session.rounds_run == 1
    model = session.round({"a": _blocks(1, 1)[0][0]})
    before = [w.clone() for w in model.weights]
    model2 = session.round({})
    for w0, w1 in zip(before, model2.weights, strict=True):
        assert torch.equal(w0, w1)
    assert session.staleness("a") == 1 and not session.is_fresh("a")
    assert session.engine.model_version == 3


def test_async_single_site_round_matches_fit():
    x = _blocks(1, 1, n=120)[0][0]
    session = _engine(federation="async").session()
    model = session.round({"solo": x})
    assert_models_match(tdaef.fit(_tcfg(), x, device="cpu"), model, LAM_LAST)
    assert session.sites == {"solo": 0}


def test_round_rejects_bad_parts_as_the_reference():
    cases = [42, {"a": np.zeros((M0 + 1, 8), np.float32)}]
    for parts in cases:
        with pytest.raises(JPlanError) as jerr:
            JEngine(_jcfg()).session().round(
                parts if not isinstance(parts, dict) else {k: jnp.asarray(v)
                                                           for k, v in parts.items()})
        with pytest.raises(PlanError) as terr:
            _engine().session().round(parts)
        assert str(terr.value) == str(jerr.value)


def test_staleness_bound_excludes_and_replays():
    a, b = _blocks(2, 3, seed=2)
    session = _engine(federation="async", merge="sequential", max_staleness=0).session()
    session.round({"a": a[0], "b": b[0]})
    model = session.round({"a": a[1]})
    assert session.staleness("b") == 1 and not session.is_fresh("b")
    assert_models_match(_reference(_tcfg(), [a[:2]]), model, LAM_LAST)
    rejoin = np.concatenate(b[1:], axis=1)
    model = session.round({"a": a[2], "b": rejoin})
    assert session.is_fresh("b") and session._ledger["b"].submits == 2
    assert_models_match(_reference(_tcfg(), [a, [b[0], rejoin]]), model, LAM_LAST)


def test_max_staleness_keeps_lagging_site():
    a, b = _blocks(2, 2, seed=3)
    session = _engine(federation="async", merge="sequential", max_staleness=1).session()
    session.round({"a": a[0], "b": b[0]})
    model = session.round({"a": a[1]})
    assert session.staleness("b") == 1 and session.is_fresh("b")
    assert_models_match(_reference(_tcfg(), [a, b[:1]]), model, LAM_LAST)


def test_site_joins_mid_session():
    a, b, c = _blocks(3, 2, seed=4)
    session = _engine(federation="async", merge="pairwise").session()
    session.round({"a": a[0], "b": b[0]})
    model = session.round({"a": a[1], "b": b[1], "c": c[0]})
    assert set(session.sites) == {"a", "b", "c"}
    assert_models_match(_reference(_tcfg(), [a, b, c[:1]]), model, LAM_LAST)
    session.reset()
    assert session.model is None and session.sites == {} and session.clock == 0


def test_merge_after_reduce_commutes():
    xa = np.stack([b[0] for b in _blocks(4, 1, seed=8)])
    xb = np.stack([b[0] for b in _blocks(4, 1, seed=9)])
    engine = _engine(mode="vmap", tenants=4, merge="pairwise")
    fa, fb = engine.fit(xa), engine.fit(xb)
    reduced_then_merged = engine.for_tenants(2).merge(engine.reduce(fa, 2), engine.reduce(fb, 2))
    merged_then_reduced = engine.reduce(engine.merge(fa, fb), 2)
    for wa, wb in zip(reduced_then_merged.model.weights, merged_then_reduced.model.weights,
                      strict=True):
        assert_close(wa, wb, atol=5e-4, rtol=1e-3)  # tests/test_async_federation.py's bar


def test_vmap_rounds_batch_equal_widths_into_one_fleet_fit(monkeypatch):
    """Equal-width async rounds under a vmap plan fit as one fleet; ragged
    rounds and loop plans fit per site; the states agree."""
    from repro_torch.core import fleet

    calls = []
    real = fleet._fit_fleet
    monkeypatch.setattr(fleet, "_fit_fleet", lambda *a, **k: calls.append(1) or real(*a, **k))
    blocks = [b[0] for b in _blocks(4, 1, seed=6)]
    batched = _engine(federation="async").session()._local_states(list(enumerate(
        torch.from_numpy(np.array(b)) for b in blocks)))
    assert calls == [1]
    looped = _engine(mode="loop", federation="async").session()._local_states(list(enumerate(
        torch.from_numpy(np.array(b)) for b in blocks)))
    _engine(federation="async").session()._local_states(
        [(0, torch.from_numpy(np.array(blocks[0]))), (1, torch.from_numpy(np.array(_x()[:, :70])))])
    assert calls == [1]
    for (e1, k1, r1), (e2, k2, r2) in zip(batched, looped, strict=True):
        assert isinstance(r1, np.ndarray) and r1.shape == (60,)
        assert_close(r1, r2)
        assert_sum_close(*((f.u * f.s[None, :] ** 2) @ f.u.T for f in (e1, e2)))
        for a, b in zip(k1, k2, strict=True):
            assert_sum_close(a.g, b.g)


# ---------------------------------------------------------------------------
# exchange states and their additive wire form
# ---------------------------------------------------------------------------

def _states(method="gram", seed=10):
    """The exchange states of three sites, in both packages."""
    parts = [b[0] for b in _blocks(3, 1, seed=seed)]
    jm = [jdaef.fit(_jcfg(method), jnp.asarray(p)) for p in parts]
    tm = [tdaef.fit(_tcfg(method), p, device="cpu") for p in parts]
    jst = [(m.encoder_factors, m.layer_knowledge, np.asarray(m.train_errors)) for m in jm]
    tst = [(dsvd.pad_rank(m.encoder_factors, M0), m.layer_knowledge,
            m.train_errors.numpy()) for m in tm]
    return jst, tst


def _gram(f):
    u, s = (np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a) for a in f)
    return (u * s**2) @ u.T


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_merge_exchange_states_matches_the_reference(method):
    jst, tst = _states(method)
    jenc, jknw, jerr = jfed.merge_exchange_states(_jcfg(method), jst)
    tenc, tknw, terr = tfed.merge_exchange_states(_tcfg(method), tst)
    assert isinstance(terr, np.ndarray)
    assert_close(terr, jerr)
    assert_sum_close(_gram(tenc), _gram(jenc))
    for tk, jk in zip(tknw, jknw, strict=True):
        t_g, j_g = ((trol.factors_to_stats(tk), jrol.factors_to_stats(jk))
                    if method == "svd" else (tk, jk))
        assert_sum_close(t_g.g, j_g.g)
        assert_sum_close(t_g.m, j_g.m)
    # error pools held as tensors concatenate on their device
    _, _, on_device = tfed.merge_exchange_states(
        _tcfg(method), [(e, k, torch.from_numpy(r)) for e, k, r in tst])
    assert isinstance(on_device, torch.Tensor) and torch.equal(on_device, torch.from_numpy(terr))
    with pytest.raises(ValueError, match="empty state list"):
        tfed.merge_exchange_states(_tcfg(method), [])


def test_additive_wire_matches_the_reference():
    jst, tst = _states()
    for js, ts in zip(jst, tst, strict=True):
        jl = jfed.exchange_to_additive(_jcfg(), js)
        tl = tfed.exchange_to_additive(_tcfg(), ts)
        assert len(tl) == len(jl) == 2 + 2 * (len(LAYERS) - 2)
        assert all(isinstance(leaf, np.ndarray) for leaf in tl)
        for i, (a, b) in enumerate(zip(tl[:-1], jl[:-1], strict=True)):
            assert a.shape == b.shape
            assert_sum_close(a, b, what=f"leaf {i}")
        np.testing.assert_array_equal(tl[-1], jl[-1])  # the error histogram
    summed = [sum(leaves) for leaves in zip(*(tfed.exchange_to_additive(_tcfg(), s)
                                              for s in tst), strict=True)]
    jsummed = [sum(leaves) for leaves in zip(*(jfed.exchange_to_additive(_jcfg(), s)
                                               for s in jst), strict=True)]
    tenc, tknw, tpool = tfed.additive_to_exchange(_tcfg(), summed, device="cpu")
    jenc, jknw, jpool = jfed.additive_to_exchange(_jcfg(), jsummed)
    assert_sum_close(_gram(tenc), _gram(jenc))
    for tk, jk in zip(tknw, jknw, strict=True):
        assert tk.g.dtype == torch.float32
        assert_sum_close(tk.g, jk.g)
        assert_sum_close(tk.m, jk.m)
    np.testing.assert_array_equal(tpool, jpool)
    assert tpool.shape == (tfed.EXCHANGE_ERR_POOL,) and tpool.dtype == np.float32
    with pytest.raises(ValueError) as terr:
        tfed.additive_to_exchange(_tcfg(), summed[:-1], device="cpu")
    with pytest.raises(ValueError) as jerr:
        jfed.additive_to_exchange(_jcfg(), jsummed[:-1])
    assert str(terr.value) == str(jerr.value)


def test_additive_wire_refuses_factor_knowledge_as_the_reference():
    jst, tst = _states("svd")
    with pytest.raises(ValueError) as jerr:
        jfed.exchange_to_additive(_jcfg("svd"), jst[0])
    with pytest.raises(ValueError) as terr:
        tfed.exchange_to_additive(_tcfg("svd"), tst[0])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="expected gram RolannStats"):
        tfed.exchange_to_additive(_tcfg(), (tst[0][0], tst[0][1], tst[0][2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_histograms_bit_identical(seed):
    rng = np.random.default_rng(seed)
    errors = np.abs(rng.normal(scale=1.5, size=300)).astype(np.float32)
    errors[:3] = [0.0, 4.0, 9.5]  # the edges and an overflow
    h = tfed.errors_to_histogram(torch.from_numpy(errors))
    np.testing.assert_array_equal(h, jfed.errors_to_histogram(errors))
    np.testing.assert_array_equal(tfed.histogram_to_pool(h), jfed.histogram_to_pool(h))
    np.testing.assert_array_equal(
        tfed.errors_to_histogram(errors[:100]) + tfed.errors_to_histogram(errors[100:]), h)


def test_nbytes_counts_elements_times_their_size():
    m = tdaef.fit(_tcfg(), _x(n=60, seed=3), device="cpu")
    upd = tfed.publish(m)
    want = sum(t.numel() * t.element_size() for t in (*m.encoder_factors,
                                                      *[leaf for k in m.layer_knowledge
                                                        for leaf in k]))
    assert upd.nbytes() == want
    double = tfed.ModelUpdate(
        encoder_factors=dsvd.SvdFactors(*(t.double() for t in m.encoder_factors)),
        layer_knowledge=m.layer_knowledge, n_samples=60)
    assert double.nbytes() == want + sum(t.numel() * 4 for t in m.encoder_factors)
