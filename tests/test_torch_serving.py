"""repro_torch.serving against repro.serving (tests/test_serving.py's cases).

* The numpy-only pieces — ``RequestQueue``, ``TilePacker``,
  ``sample_hashes`` / ``ScoreCache``, ``ErrorSketch``, ``percentile`` /
  ``latency_summary`` — are copies: the same inputs give identical outputs
  (exact equality).
* ``FleetServer`` serves the reference's fleet (moved by ``interop``) with
  scores within ``TOLS`` of the reference ``FleetServer``'s and within
  rtol 1e-5 / atol 1e-6 of the port's pad path (``engine.scores`` with
  ``n_valid``; tests/test_serving.py's bar for the same comparison).  Flags
  are equal except where a score lies within 1e-5 relative of its
  threshold (the scores' own tolerance can move it across).
* On the host the server scores eagerly; every dispatched tile shape is one
  ``warmup`` prepared (the reference's "no retrace after warmup").  The
  card's CUDA graphs are tested in tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.core import anomaly as janomaly
from repro.core import daef as jdaef
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.serving import ErrorSketch as JSketch
from repro.serving import FleetServer as JServer
from repro.serving import RequestQueue as JQueue
from repro.serving import ScoreCache as JCache
from repro.serving import ScoreRequest as JRequest
from repro.serving import TilePacker as JPacker
from repro.serving import latency_summary as jlatency
from repro.serving import sample_hashes as jhashes
from repro_torch import interop
from repro_torch.core import anomaly, daef
from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError
from repro_torch.serving import (ErrorSketch, FleetServer, RequestQueue, ScoreCache,
                                 ScoreRequest, TilePacker, latency_summary, percentile,
                                 sample_hashes)
from repro_torch.serving import server as server_mod

K, M0 = 4, 6


def make_request(tenant: int, n: int, request_id: int = 0, seed: int = 0,
                 cls=ScoreRequest):
    rng = np.random.default_rng(seed + 17 * tenant)
    x = rng.normal(size=(M0, n)).astype(np.float32)
    return cls(request_id=request_id, tenant=tenant, x=x,
               scores=np.full(n, np.nan, np.float32),
               flags=np.zeros(n, np.int32), pending=n)


def _cfg_kw():
    return dict(layer_sizes=(M0, 3, 5, M0), lam_hidden=0.9, lam_last=0.9)


@functools.lru_cache(maxsize=None)
def _reference_fleet():
    """The reference engine and its fleet, fit once (tests/test_serving.py's
    data, one more hidden layer)."""
    engine = JEngine(jdaef.DAEFConfig(**_cfg_kw()), JPlan(mode="vmap", tenants=K))
    xs = np.random.default_rng(0).normal(size=(K, M0, 64)).astype(np.float32)
    return engine, engine.fit(xs, seeds=jnp.arange(K))


def _served():
    """The port's engine serving the reference's fleet, on the host."""
    _, jfl = _reference_fleet()
    cfg = daef.DAEFConfig(**_cfg_kw())
    engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=K), device="cpu")
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jfl)[0]]
    return engine, interop.fleet_from_numpy(cfg, leaves, device="cpu")


@pytest.fixture()
def served():
    return _served()


def _flags_match(got, want, scores, mus, tenants) -> None:
    """Flags equal except where a score is within 1e-5 relative of mu."""
    tie = np.abs(scores - mus[tenants]) <= 1e-5 * np.abs(mus[tenants])
    assert np.array_equal(got[~tie], want[~tie])


def _pad_path(engine, fl, reqs):
    counts = np.array([x.shape[1] for x in reqs])
    batch = np.zeros((K, M0, int(counts.max())), np.float32)
    for t, x in enumerate(reqs):
        batch[t, :, : counts[t]] = x
    return engine.scores(fl, batch, n_valid=counts).numpy(), counts


def _serve(server, reqs):
    rids = [server.submit(t, x) for t, x in enumerate(reqs)]
    server.flush()
    return [server.take(rid) for rid in rids]


# ----------------------------------------------------------------------
# the numpy-only copies: identical outputs
# ----------------------------------------------------------------------

def test_queue_matches_the_reference():
    queues = (RequestQueue(), JQueue())
    for q, cls in zip(queues, (ScoreRequest, JRequest)):
        for t, n in ((0, 3), (2, 9), (1, 5), (2, 4)):
            r = make_request(t, n, cls=cls)
            q.push(r, np.arange(n))
    log = [[], []]
    for q, out in zip(queues, log):
        out.append((len(q), q.pending_tenants, q.largest_tenant(), q.next_tenant()))
        limits = iter((4, 100, 2, 7, 1, 50) * 4)
        while q:
            t = q.largest_tenant()
            item = q.take(t, next(limits))
            q.rotate(t)
            out.append((t, item[1].tolist(), len(q), q.pending_for(t), bool(q)))
        assert q.take(0, 4) is None and q.largest_tenant() is None
    assert log[0] == log[1]


@pytest.mark.parametrize("slots,width,widths,order", [
    (8, 8, [5, 12, 3, 8], "largest"), (4, 8, [20], "largest"),
    (3, 16, [1, 2, 40, 7, 9], "fifo"), (64, 32, [64, 1, 33, 2, 17, 5], "largest"),
])
def test_packer_matches_the_reference(slots, width, widths, order):
    tiles = []
    for packer, qcls, rcls in ((TilePacker(M0, slots=slots, width=width, order=order),
                                RequestQueue, ScoreRequest),
                               (JPacker(M0, slots=slots, width=width, order=order),
                                JQueue, JRequest)):
        q = qcls()
        for t, n in enumerate(widths):
            r = make_request(t, n, request_id=t, cls=rcls)
            q.push(r, np.arange(n))
        out = []
        while (tile := packer.pack(q)) is not None:
            out.append((tile.x, tile.slot_tenants, tile.n_valid,
                        [(a.slot, a.tenant, a.request.request_id, a.cols.tolist(), a.start)
                         for a in tile.assignments]))
            assert (tile.x.shape[0], tile.x.shape[2]) in packer.shapes()
        tiles.append(out)
    assert len(tiles[0]) == len(tiles[1])
    for a, b in zip(*tiles):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


def test_packer_shapes_match_the_reference():
    for slots, width in ((64, 32), (32, 256), (4, 8), (1, 1), (17, 5)):
        assert TilePacker(M0, slots=slots, width=width).shapes() == \
            JPacker(M0, slots=slots, width=width).shapes()
    assert len(TilePacker(29, slots=64, width=32).shapes()) == 36
    with pytest.raises(ValueError, match="slots >= 1"):
        TilePacker(M0, slots=0)


def test_packer_tile_is_dense_and_routes_correctly():
    q = RequestQueue()
    for t, n in enumerate([5, 12, 3, 8]):
        r = make_request(t, n, request_id=t)
        q.push(r, np.arange(r.n_samples))
    tile = TilePacker(M0, slots=8, width=8).pack(q)
    for a in tile.assignments:
        got = tile.x[a.slot, :, a.start:a.start + a.cols.size]
        np.testing.assert_array_equal(got, a.request.x[:, a.cols])
        assert tile.slot_tenants[a.slot] == a.tenant == a.request.tenant
    for s in range(tile.x.shape[0]):
        assert not np.any(tile.x[s, :, tile.n_valid[s]:])


def test_cache_and_hashes_match_the_reference():
    x = np.random.default_rng(0).normal(size=(M0, 5)).astype(np.float32)
    wide = np.random.default_rng(1).normal(size=(128, 3)).astype(np.float32)
    for a in (x, wide):
        assert sample_hashes(a) == jhashes(a)
    caches = (ScoreCache(max_entries=4), JCache(max_entries=4))
    log = [[], []]
    for c, out in zip(caches, log):
        for i in range(6):
            c.put(0, 0, bytes([i]), float(i))
        c.put_many(1, 2, [b"a", b"b"], [1.5, 2.5])
        out.append((len(c), c.get(0, 0, bytes([0])), c.get(1, 2, b"a"),
                    c.get_many(1, 2, [b"a", b"z", b"b"])))
        c.put_threshold(3, 2, 0.5)
        c.put(1, 3, b"new", 1.0)
        out.append((c.drop_stale(version=3), c.get_threshold(3, 2), c.get(1, 3, b"new"),
                    repr(c)))
    assert log[0] == log[1]


@pytest.mark.parametrize("rule", ["q90", "q97.5", "unusual_iqr", "extreme_iqr"])
def test_sketch_matches_the_reference(rule):
    rng = np.random.default_rng(0)
    blocks = [rng.gamma(2.0, 1.0, size=n).astype(np.float32) for n in (400, 150, 250)]
    blocks[1][:3] = np.nan
    ours, ref = ErrorSketch(bins=256), JSketch(bins=256)
    for b in blocks:
        ours.add(b)
        ref.add(b)
        assert ours.threshold(rule) == ref.threshold(rule)
    np.testing.assert_array_equal(ours.counts, ref.counts)
    assert (ours.lo, ours.width, ours.n, repr(ours)) == (ref.lo, ref.width, ref.n, repr(ref))
    merged = ErrorSketch.from_errors(blocks[0]).merge(ErrorSketch.from_errors(blocks[2] * 3))
    jmerged = JSketch.from_errors(blocks[0]).merge(JSketch.from_errors(blocks[2] * 3))
    assert merged.quantile(0.9) == jmerged.quantile(0.9)
    # against a from-scratch quantile of the port's anomaly module
    every = np.concatenate(blocks)
    exact = float(anomaly.threshold(torch.from_numpy(every[np.isfinite(every)]), rule,
                                    device="cpu"))
    assert ErrorSketch.from_errors(every).threshold(rule) == pytest.approx(exact, rel=0.02)


def test_metrics_match_the_reference():
    vals = [1.0, 2.0, 3.0, 4.0, 10.0]
    assert percentile(vals, 50) == 3.0 and percentile(vals, 95) == np.percentile(vals, 95)
    assert latency_summary([0.01, 0.02, 0.05], 300) == jlatency([0.01, 0.02, 0.05], 300)
    with pytest.raises(ValueError, match="empty"):
        percentile([], 50)


# ----------------------------------------------------------------------
# FleetServer against the reference server and the pad path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,tile_width,use_cache", [(3, 8, True), (4, 4, False),
                                                       (5, 32, True), (6, 2, True)])
def test_server_matches_the_reference_and_the_pad_path(seed, tile_width, use_cache):
    engine, fl = _served()
    jengine, jfl = _reference_fleet()
    rng = np.random.default_rng(seed)
    reqs = [rng.normal(size=(M0, int(n))).astype(np.float32)
            for n in rng.integers(1, 20, size=K)]
    server = FleetServer(engine, fl, tile_width=tile_width, rule="q90",
                         use_cache=use_cache)
    jserver = JServer(jengine, jfl, tile_width=tile_width, rule="q90", use_cache=use_cache)
    got, want = _serve(server, reqs), _serve(jserver, reqs)
    assert server.stats == jserver.stats
    mus = server.thresholds
    np.testing.assert_array_equal(mus, jserver.thresholds)
    pad, counts = _pad_path(engine, fl, reqs)
    for t, (g, w) in enumerate(zip(got, want)):
        assert (g.request_id, g.tenant, g.cached_cols) == (w.request_id, w.tenant,
                                                           w.cached_cols)
        assert g.scores.dtype == np.float32 and g.flags.dtype == np.int32
        assert_close(g.scores, w.scores)
        np.testing.assert_allclose(g.scores, pad[t, : counts[t]], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g.flags, (g.scores > mus[t]).astype(np.int32))
        _flags_match(g.flags, w.flags, g.scores, mus, np.full(len(g.scores), t))


def test_score_tile_masks_padding_and_thresholds():
    engine, fl = _served()
    rng = np.random.default_rng(1)
    tile = torch.from_numpy(rng.normal(size=(3, M0, 8)).astype(np.float32))
    slots = torch.tensor([2, 0, 2])
    n_valid = torch.tensor([8, 3, 0])
    mus = torch.tensor([0.5, 0.6, 0.7, 0.8])
    leaves = (fl.model.weights, fl.model.biases)
    errs, flags = server_mod._score_tile(engine.config, leaves, tile, slots, n_valid, mus)
    assert errs.shape == flags.shape == (3, 8) and flags.dtype == torch.int32
    assert torch.isnan(errs[1, 3:]).all() and torch.isnan(errs[2]).all()
    for i, t in enumerate(slots.tolist()):
        want = daef.reconstruction_error(engine.config, fleet_model(fl, t), tile[i],
                                         device="cpu")
        assert_close(errs[i, : n_valid[i]], want[: n_valid[i]], atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(flags.numpy(), (errs > mus[slots][:, None]).int().numpy())
    assert not flags[2].any()  # NaN padding classifies 0


def fleet_model(fl, t):
    from repro_torch.core import fleet

    return fleet.get_model(fl, t)


def test_server_rejects_bad_requests(served):
    engine, fl = served
    server = FleetServer(engine, fl)
    with pytest.raises(PlanError, match="features"):
        server.submit(0, np.zeros((M0 + 1, 3), np.float32))
    with pytest.raises(PlanError, match="tenant"):
        server.submit(K, np.zeros((M0, 3), np.float32))
    with pytest.raises(PlanError, match="DAEFFleet"):
        FleetServer(engine, fleet_model(fl, 0))
    with pytest.raises(PlanError, match="tenants=2"):
        FleetServer(DAEFEngine(engine.config, ExecutionPlan(mode="vmap", tenants=2),
                               device="cpu"), fl)
    with pytest.raises(PlanError, match="update_state"):
        server.update_state(fleet_model(fl, 0))


def test_cached_requests_skip_dispatch_until_version_bump(served, monkeypatch):
    engine, fl = served
    server = FleetServer(engine, fl, rule="q90")
    x = np.random.default_rng(5).normal(size=(M0, 8)).astype(np.float32)
    calls = []
    real = server_mod._score_tile

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(server_mod, "_score_tile", spy)
    rid = server.submit(2, x)
    server.flush()
    first = server.take(rid)
    assert calls and first.cached_cols == 0
    calls.clear()
    rid = server.submit(2, x)
    assert not calls
    cached = server.take(rid)  # done at submit, no flush needed
    assert cached.cached_cols == 8
    np.testing.assert_array_equal(cached.scores, first.scores)
    assert server.stats["cache_hit_cols"] == 8
    v0 = server.version
    x_new = np.random.default_rng(6).normal(size=(K, M0, 16)).astype(np.float32)
    server.partial_fit(x_new)
    assert server.version > v0 and engine.model_version > 0
    calls.clear()
    rid = server.submit(2, x)
    server.flush()
    rescored = server.take(rid)
    assert calls and rescored.cached_cols == 0
    # the new model's leaves are what the server now scores with
    pad, _ = _pad_path(engine, server.state, [x] * K)
    np.testing.assert_allclose(rescored.scores, pad[2], rtol=1e-5, atol=1e-6)


def test_update_state_refills_the_scoring_buffers(served):
    engine, fl = served
    server = FleetServer(engine, fl, rule="q90")
    leaves = server._leaves
    fl2 = engine.partial_fit(fl, np.random.default_rng(7).normal(
        size=(K, M0, 16)).astype(np.float32))
    server.update_state(fl2)
    assert server._leaves is leaves  # the same buffers, refilled
    for dst, src in zip(leaves[0] + leaves[1], fl2.model.weights + fl2.model.biases):
        assert torch.equal(dst, src) and dst.data_ptr() != src.data_ptr()
    fresh = engine.fit(np.random.default_rng(8).normal(size=(K, M0, 40)).astype(np.float32))
    server.update_state(fresh)  # not an append: the sketches rebuild
    assert server.stats["recalibrations"] == 2
    np.testing.assert_array_equal(
        server.thresholds,
        np.array([ErrorSketch.from_errors(e, bins=1024).threshold("q90")
         for e in fresh.model.train_errors.numpy()], np.float32))


def test_server_online_recalibration_matches_full_pass(served):
    engine, fl = served
    server = FleetServer(engine, fl, rule="q95")
    x_new = np.random.default_rng(8).normal(size=(K, M0, 128)).astype(np.float32) * 1.5
    fl2 = server.partial_fit(x_new)
    assert server.stats["recalibrations"] == 1
    errors = fl2.model.train_errors.numpy()
    mus = server.thresholds
    for t in range(K):
        exact = float(janomaly.threshold(jnp.asarray(errors[t]), "q95"))
        assert mus[t] == pytest.approx(exact, rel=0.05)


def test_no_new_shapes_after_warmup_mixed_ragged(served, monkeypatch):
    """warmup() prepares every packer tile shape; serving any mix of ragged
    request widths afterwards dispatches only those shapes."""
    engine, fl = served
    server = FleetServer(engine, fl, tile_width=8, rule="q90")
    seen = []
    real = server_mod._score_tile

    def spy(config, model, tile, *rest):
        seen.append((tile.shape[0], tile.shape[2]))
        return real(config, model, tile, *rest)

    monkeypatch.setattr(server_mod, "_score_tile", spy)
    assert server.warmup() == len(server.packer.shapes())
    warmed = set(seen)
    assert warmed == set(server.packer.shapes())
    seen.clear()
    rng = np.random.default_rng(11)
    rids = []
    for widths in [(1, 9, 4, 17), (3, 1, 23, 8)]:
        for t, n in enumerate(widths):
            rids.append(server.submit(t, rng.normal(size=(M0, n)).astype(np.float32)))
        server.flush()
    results = [server.take(rid) for rid in rids]
    assert seen and set(seen) <= warmed
    assert all(np.isfinite(r.scores).all() for r in results)
    rep = server.probe_donation()
    assert rep.backend == "cpu" and rep.effective_params is None and rep.ok is None
    assert rep.requested == (2,) and "unknown" in rep.describe()


def test_readback_validation(served):
    engine, fl = served
    with pytest.raises(PlanError, match="readback"):
        FleetServer(engine, fl, readback="bogus")
    with pytest.raises(PlanError, match="max_inflight"):
        FleetServer(engine, fl, readback="deferred", max_inflight=0)
    assert FleetServer(engine, fl, readback="per_tile", max_inflight=32).max_inflight == 1


def test_deferred_readback_matches_per_tile(served):
    engine, fl = served
    results = {}
    for readback, inflight in (("per_tile", 32), ("deferred", 4), ("deferred", 1)):
        server = FleetServer(engine, fl, tile_width=8, rule="q90",
                             readback=readback, max_inflight=inflight)
        rids = []
        for rid, (t, n) in enumerate([(0, 9), (1, 4), (2, 17), (3, 1), (0, 23), (2, 8)]):
            rids.append(server.submit(t, make_request(t, n, seed=5).x,
                                      request_id=100 + rid))
        server.flush()
        results[(readback, inflight)] = [server.take(r) for r in rids]
    ref = results[("per_tile", 32)]
    for got in results.values():
        for r_ref, r_got in zip(ref, got):
            np.testing.assert_array_equal(r_ref.scores, r_got.scores)
            np.testing.assert_array_equal(r_ref.flags, r_got.flags)
            assert np.isfinite(r_got.scores).all()


def test_deferred_bounds_inflight_queue(served):
    engine, fl = served
    server = FleetServer(engine, fl, tile_width=4, rule="q90",
                         readback="deferred", max_inflight=2)
    for rid in range(8):
        server.submit(rid % K, make_request(rid % K, 4, seed=9).x, request_id=rid)
    while server.step():
        assert len(server._inflight) <= server.max_inflight
    server.flush()
    assert len(server._inflight) == 0
    for rid in range(8):
        assert np.isfinite(server.take(rid).scores).all()
    assert "FleetServer(tenants=4" in repr(server)
