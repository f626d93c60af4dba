"""The port's DAEF mesh paths in one process, one rank, against the
reference's same calls on this process's one JAX CPU device (its
one-device mesh; tests/test_torch_mesh_distributed.py runs four ranks).

* ``mode="mesh"`` tenant plans (K = 4 and 8): fit, the chunked fit,
  ``fit_stream``, ``partial_fit`` (donating into the shard's leaves),
  scores with a padding mask and thresholds — bit-identical to the port's
  ``vmap`` plan (placement is the whole story) and held to the reference
  (``fit_stream`` through the vmap plan's, which tests/test_torch_engine.py
  holds to the reference's: the reference's streamed fit compiles ~8 s a
  fleet shape).
* ``reduce(merge="tree")`` with groups 1, 2 and 4, both methods.
* The data-sharded fit: gram, svd × ``gram_eigh`` / ``local_svd``, a
  deeper decoder through ``sharded.fit_on_mesh`` on ``make_host_mesh``,
  its scores, thresholds and ``partial_fit``.
* The sync, async (masked, 3 of 4 sites fresh) and secagg tree rounds.
* ``fit_head(mesh=)``, ``pipeline.shard_batch`` and the mesh helpers.
* ``merge_wire_tree`` bit for bit; every reference ``PlanError`` and
  ``ValueError`` of a bad mesh, group or mask, word for word.

Tenants and sites draw their own ``lowrank_data`` mixtures.  Some of
those tenants' last layers are nearly all regularizer (|W| ~1e-3), where
M is the small remainder of a cancelling sum: the last layer is then held
at the larger of the κ bar and ``cancellation_bar`` (tests/_torch_parity.py
derives it; ROADMAP queue C classified the gap as float32 rounding, the
port and the reference agreeing to ~5e-15 in float64).

Models are held by ``assert_models_match`` (tests/_torch_parity.py: TOLS,
float32 atol = rtol = 1e-4; sums at 1e-4 of their max; the last layer at
the κ or cancellation bar), scores and thresholds at TOLS.  9-3-5-7-9 nets, 16–120 samples.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import assert_close, assert_models_match, lowrank_data

from repro.core import daef as jdaef
from repro.core import fleet as jfleet
from repro.core import fleet_sharded as jfs
from repro.core import rolann as jrol
from repro.core import sharded as jsharded
from repro.data import pipeline as jpipe
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.engine import PlanError as JPlanError
from repro.launch import mesh as jmesh
from repro.models import daef_head as jhead
from repro.privacy import PrivacySpec as JSpec
from repro_torch.core import daef as tdaef
from repro_torch.core import fleet as tfleet
from repro_torch.core import fleet_sharded as tfs
from repro_torch.core import rolann as trol
from repro_torch.core import sharded as tsharded
from repro_torch.data import pipeline as tpipe
from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError
from repro_torch.launch import mesh as tmesh
from repro_torch.models import daef_head
from repro_torch.privacy import PrivacySpec

M0, LATENT = 9, 3
LAYERS = (M0, LATENT, 5, 7, M0)
LAM_LAST = 0.9


def _kw(method="gram", **kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method=method,
                     stats_backend="einsum", seed=1), **kw)


def _tcfg(method="gram", **kw):
    return tdaef.DAEFConfig(**_kw(method, **kw))


def _jcfg(method="gram", **kw):
    return jdaef.DAEFConfig(**_kw(method, **kw))


def _engine(cfg=None, **plan):
    return DAEFEngine(cfg or _tcfg(), ExecutionPlan(**plan), device="cpu")


@functools.lru_cache(maxsize=None)
def _xs(k, n, seed):
    xs = np.stack([lowrank_data(M0, LATENT, n, seed=seed + 100 * t) for t in range(k)])
    xs.flags.writeable = False
    return xs


def _as_gram(model):
    if hasattr(model.layer_knowledge[0], "u"):
        lib = trol if isinstance(model, tdaef.DAEFModel) else jrol
        return model._replace(layer_knowledge=tuple(
            lib.factors_to_stats(k) for k in model.layer_knowledge))
    return model


def _match(jm, tm):
    assert_models_match(_as_gram(jm), _as_gram(tm), LAM_LAST, m_cancels=True)


def _match_fleet(jfl, tfl):
    assert tfl.size == jfl.size
    assert np.array_equal(tfl.seeds.numpy(), np.asarray(jfl.seeds))
    for i in range(tfl.size):
        _match(jfleet.get_model(jfl, i), tfleet.get_model(tfl, i))


def _equal(a, b):
    la, lb = tfleet._tree_leaves(a), tfleet._tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# tenant-sharded plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_tenant_mesh_plan_is_the_vmap_plan_and_the_references(k):
    n, chunk = 120, 40
    xs, x2 = _xs(k, n, 11 * k), _xs(k, 40, 11 * k + 1)
    seeds = np.arange(1, k + 1, dtype=np.int32)
    n_valid = np.arange(k) % n + 1
    chunks = [xs[..., i:i + chunk] for i in range(0, n, chunk)]
    vm, me = _engine(mode="vmap", tenants=k), _engine(mode="mesh", tenants=k)
    assert me.mesh.shape == {"tenants": 1} and me.mesh.device_mesh is None
    jme = JEngine(_jcfg(), JPlan(mode="mesh", tenants=k))

    fv, fm = vm.fit(xs, seeds=seeds), me.fit(xs, seeds=seeds)
    _equal(fv, fm)
    sv, sm = vm.scores(fv, xs, n_valid=n_valid), me.scores(fm, xs, n_valid=n_valid)
    assert torch.equal(sv.isnan(), sm.isnan()) and torch.equal(sv.nan_to_num(), sm.nan_to_num())
    assert torch.equal(vm.thresholds(fv), me.thresholds(fm))
    assert torch.equal(vm.predict(fv, xs), me.predict(fm, xs))
    jfl = jme.fit(jnp.asarray(xs), seeds=jnp.asarray(seeds))
    _match_fleet(jfl, fm)
    want = np.asarray(jme.scores(jfl, jnp.asarray(xs), n_valid=n_valid))
    assert_close(np.nan_to_num(sm.numpy(), nan=-1.0), np.nan_to_num(want, nan=-1.0))
    assert_close(me.thresholds(fm), jme.thresholds(jfl))

    _equal(vm.fit_stream(chunks, seeds=seeds), me.fit_stream(chunks, seeds=seeds))
    vc = _engine(mode="vmap", tenants=k, chunk_samples=chunk)
    mc = _engine(mode="mesh", tenants=k, chunk_samples=chunk)
    _equal(vc.fit(xs, seeds=seeds), mc.fit(xs, seeds=seeds))

    upd_v = vm.partial_fit(fv, x2)
    enc_u = fm.model.encoder_factors.u
    upd_m = me.partial_fit(fm, x2)
    _equal(upd_v, upd_m)
    # donation: the fixed-shape leaves were updated in the shard's storage
    assert upd_m.model.encoder_factors.u is enc_u
    assert upd_m.model.train_errors.shape == (k, n + 40)
    _match_fleet(jme.partial_fit(jfl, jnp.asarray(x2)), upd_m)


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_tree_reduce_groups_match_the_reference(method):
    k = 4
    xs = _xs(k, 40, 23)
    seeds = np.ones(k, np.int32)
    engine = _engine(_tcfg(method), mode="mesh", tenants=k, merge="tree")
    jengine = JEngine(_jcfg(method), JPlan(mode="mesh", tenants=k, merge="tree"))
    fl = engine.fit(xs, seeds=seeds)
    jfl = jengine.fit(jnp.asarray(xs), seeds=jnp.asarray(seeds))
    assert engine.reduce(fl, 1) is fl
    for group in (2, 4):
        got = engine.reduce(fl, group)
        assert got.size == k // group
        _match_fleet(jengine.reduce(jfl, group), got)
    # a vmap plan's tree runs on this rank's one-rank mesh, as the
    # reference's runs on its one-device mesh
    vm = _engine(_tcfg(method), mode="vmap", tenants=k, merge="tree")
    _equal(engine.reduce(fl, 4), vm.reduce(vm.fit(xs, seeds=seeds), 4))


# ---------------------------------------------------------------------------
# data-sharded fit
# ---------------------------------------------------------------------------

def _mesh_data(n, seed):
    """tests/test_sharded_core.py's data-mesh samples, [M0, n]."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(LATENT, n))
    x = np.tanh(rng.normal(size=(M0, LATENT)) @ z) + 0.05 * rng.normal(size=(M0, n))
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


# The reference's data-mesh calls run under jax.jit: its eager shard_map
# compiles op by op, 12–23 s a fit on the CPU, against 1–3 s jitted (the
# two agree to 1e-6).

@pytest.mark.parametrize("method,fact", [("gram", "gram_eigh"), ("svd", "gram_eigh"),
                                         ("svd", "local_svd")])
def test_data_mesh_fit_matches_the_reference(method, fact):
    x, x2 = _mesh_data(96, 31), _mesh_data(96, 32)
    plan = dict(mode="mesh", mesh_axes=("data",), local_factorization=fact)
    engine = _engine(_tcfg(method), **plan)
    jengine = JEngine(_jcfg(method), JPlan(**plan))
    model, jmodel = engine.fit(x), jax.jit(jengine.fit)(jnp.asarray(x))
    _match(jmodel, model)
    assert_close(engine.scores(model, x), jengine.scores(jmodel, jnp.asarray(x)))
    assert_close(engine.predict(model, x), jengine.predict(jmodel, jnp.asarray(x)))
    assert_close(engine.thresholds(model), jengine.thresholds(jmodel))
    if method == "gram":
        _match(jax.jit(jengine.partial_fit)(jmodel, jnp.asarray(x2)),
               engine.partial_fit(model, x2))


def test_data_mesh_deeper_decoder_through_the_shim_on_the_host_mesh():
    layers = (M0, LATENT, 6, 4, M0)
    x = _mesh_data(96, 33)
    tcfg, jcfg = _tcfg(layer_sizes=layers), _jcfg(layer_sizes=layers)
    mesh = tmesh.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and tmesh.data_axes(mesh) == ("data",)
    got = tsharded.fit_on_mesh(tcfg, x, mesh)  # repro-lint: disable=RPR001
    assert len(got.weights) == 4 and len(got.biases) == 3
    jmesh_ = jmesh.make_host_mesh()

    def jfit(a):
        return jsharded.fit_on_mesh(jcfg, a, jmesh_)  # repro-lint: disable=RPR001

    _match(jax.jit(jfit)(jnp.asarray(x)), got)
    assert_close(tsharded.predict_on_mesh(tcfg, got, x, mesh),
                 tdaef.predict(tcfg, got, x, device="cpu"))


# ---------------------------------------------------------------------------
# federation rounds
# ---------------------------------------------------------------------------

def test_sync_tree_rounds_match_the_reference():
    parts = list(_xs(4, 30, 41))
    more = list(_xs(4, 30, 42))
    sess = _engine(merge="tree").session()
    mesh_sess = _engine(mode="mesh", tenants=4, merge="tree").session()
    jsess = JEngine(_jcfg(), JPlan(merge="tree")).session()
    for i, rnd in enumerate((parts, more)):
        got, got_mesh = sess.round(rnd), mesh_sess.round(rnd)
        _match(jsess.round([jnp.asarray(p) for p in rnd]), got)
        _equal(got, got_mesh)
        if i == 0:  # one tree round of four nodes: the stacked fleet's tree reduce
            fl = _engine(mode="vmap", tenants=4, merge="tree")
            want = fl.reduce(fl.fit(np.stack(parts), seeds=np.ones(4, np.int32)), 4)
            _equal(tfleet.get_model(want, 0), got)


def test_async_masked_tree_refresh_matches_the_reference():
    blocks = [list(_xs(4, 30, 51)), list(_xs(4, 30, 52))]
    plan = dict(federation="async", merge="tree", max_staleness=0)
    sess = _engine(**plan).session()
    jsess = JEngine(_jcfg(), JPlan(**plan)).session()
    r1 = {s: blocks[0][s] for s in range(4)}
    r2 = {s: blocks[1][s] for s in range(3)}   # site 3 misses: 3 of 4 fresh
    for rnd in (r1, r2):
        got = sess.round(rnd)
        _match(jsess.round({s: jnp.asarray(p) for s, p in rnd.items()}), got)
    assert sess.sites == {0: 0, 1: 0, 2: 0, 3: 1}
    # the masked tree equals the sequential reduce of the fresh sites
    seq = _engine(federation="async", merge="sequential", max_staleness=0).session()
    for rnd in (r1, r2):
        want = seq.round(rnd)
    assert_models_match(want, got, LAM_LAST, m_cancels=True)


def test_secagg_tree_round_matches_the_reference_and_the_pairwise_sum():
    parts = list(_xs(3, 40, 61))
    plan = dict(merge="tree", privacy=PrivacySpec(secagg=True))
    got = _engine(**plan).session().round(parts)
    want = JEngine(_jcfg(), JPlan(merge="tree", privacy=JSpec(secagg=True))).session().round(
        [jnp.asarray(p) for p in parts])
    _match(want, got)
    # uint64 wire sums are exact: the tree's aggregate is the pairwise one's
    pair = _engine(merge="pairwise", privacy=PrivacySpec(secagg=True)).session().round(parts)
    _equal(pair, got)


@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_merge_wire_tree_bit_for_bit(n):
    rng = np.random.default_rng(n)
    wires = [[rng.integers(0, 2**63, size=s, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
              for s in ((3,), (2, 4))] for _ in range(n)]
    got, want = tfs.merge_wire_tree(wires), jfs.merge_wire_tree(wires)
    seq = [sum((w[i] for w in wires[1:]), wires[0][i]) for i in range(2)]
    for g, w, s in zip(got, want, seq, strict=True):
        assert g.dtype == np.uint64 and np.array_equal(g, w) and np.array_equal(g, s)
    with pytest.raises(ValueError, match="empty wire list"):
        tfs.merge_wire_tree([])


# ---------------------------------------------------------------------------
# the head, shard_batch, the mesh helpers
# ---------------------------------------------------------------------------

def test_fit_head_on_a_data_mesh_matches_the_reference():
    rng = np.random.default_rng(71)
    feats = (rng.normal(size=(256, 4)) @ rng.normal(size=(4, 32))
             + 0.1 * rng.normal(size=(256, 32))).astype(np.float32)
    mesh = tmesh.Mesh((1,), ("data",), device="cpu")
    th = daef_head.fit_head(feats, mesh=mesh)
    jmesh_ = jmesh.make_host_mesh()

    def head(f):
        h = jhead.fit_head(f, mesh=jmesh_, data_axes=("data",))
        return h.model, h.threshold

    jmodel, jthr = jax.jit(head)(jnp.asarray(feats))
    assert th.cfg.layer_sizes == jhead.default_config(32).layer_sizes
    _match(jmodel, th.model)
    assert_close(th.threshold, jthr)
    plain = daef_head.fit_head(feats, n_partitions=1, device="cpu")
    assert torch.equal(plain.mean, th.mean) and torch.equal(plain.std, th.std)


def test_shard_batch_places_the_ranks_block():
    mesh = tmesh.Mesh((1, 1), ("pod", "data"), device="cpu")
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(4, 6),
             "x": np.linspace(0, 1, 12, dtype=np.float32).reshape(2, 6)}
    got = tpipe.shard_batch(batch, mesh, (("pod", "data"), None))
    want = jpipe.shard_batch(batch, jmesh.make_host_mesh(), P("data", None))
    for key in batch:
        assert got[key].dtype == torch.from_numpy(np.asarray(want[key])).dtype
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
    fl = _engine(mode="vmap", tenants=4).fit(_xs(4, 20, 81))
    one = tfs.tenant_mesh(device="cpu")
    _equal(tfs.gather_fleet(tfs.shard_fleet(fl, one), one), fl)
    assert torch.equal(tfs.shard_batch(_xs(4, 20, 81), one), torch.from_numpy(_xs(4, 20, 81)))


def test_mesh_helpers(monkeypatch):
    assert tmesh.world_size() == 1
    mesh = tmesh.make_tenant_mesh(device="cpu")
    assert mesh.axis_names == ("tenants",) and mesh.size == 1 and mesh.rank == 0
    t = torch.arange(3.0)
    assert mesh.gather(t, ("tenants",), 0) is t and mesh.psum(t, ("tenants",)) is t
    assert mesh.gather_axis(t, "tenants") == [t] and mesh.index(("tenants",)) == (0, 1)
    with pytest.raises(ValueError, match="needs a multi-rank mesh"):
        mesh.exchange(t, 0)
    with pytest.raises(ValueError, match=r"need 1 <= n_devices <= 1, got 2"):
        tfs.tenant_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="bad mesh size"):
        tmesh.Mesh((2,), ("data",), device="cpu")
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        tmesh.rank_device(None)
    with pytest.raises(RuntimeError, match="none is present"):
        DAEFEngine(_tcfg(), ExecutionPlan(mode="mesh", tenants=2))


# ---------------------------------------------------------------------------
# errors, word for word
# ---------------------------------------------------------------------------

def _same_error(jcall, tcall, jtype=ValueError):
    with pytest.raises(jtype) as jerr:
        jcall()
    with pytest.raises(ValueError) as terr:
        tcall()
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("plan", [
    dict(mode="mesh", tenants=8, mesh_devices=4),
    dict(mode="mesh", mesh_axes=("data",), mesh_devices=2),
    dict(mode="mesh", mesh_axes=("pod", "data")),
], ids=["tenant mesh sized", "data mesh sized", "multi-axis auto"])
def test_bad_mesh_plans_raise_the_references_plan_error(plan):
    def j():
        JEngine(_jcfg(), JPlan(**plan)).mesh

    def t():
        _engine(**plan).mesh

    _same_error(j, t, JPlanError)


def test_ranks_that_do_not_tile_the_fleet_raise(monkeypatch):
    """A mesh may span some of the ranks, sized as the reference's: with
    four ranks, an automatic tenant mesh over six tenants takes three (the
    largest divisor of the fleet that fits the ranks), and
    ``mesh_devices=2`` takes two, for a tenant and for a data mesh — the
    reference's sizes on four devices.  ``mesh_devices`` past the world
    still raises the reference's error.  (No process group here: the mesh
    is this process alone; tests/test_torch_mesh_distributed.py runs these
    meshes on four gloo ranks, one of them idle.)"""
    from repro import compat

    monkeypatch.setattr(tmesh, "world_size", lambda: 4)
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * 4)
    monkeypatch.setattr(compat, "make_mesh", lambda shape, axes: dict(zip(axes, shape)))
    for plan, want in ((dict(mode="mesh", tenants=6), {"tenants": 3}),
                       (dict(mode="mesh", tenants=8, mesh_devices=2), {"tenants": 2}),
                       (dict(mode="mesh", mesh_axes=("data",), mesh_devices=2), {"data": 2})):
        assert JEngine(_jcfg(), JPlan(**plan)).mesh == want
        mesh = _engine(**plan).mesh
        assert mesh.shape == want and mesh.size == sum(want.values())
        assert mesh.member and mesh.rank == 0 and mesh.group is None
    for plan in (dict(mode="mesh", tenants=8, mesh_devices=8),
                 dict(mode="mesh", mesh_axes=("data",), mesh_devices=8)):
        _same_error(lambda plan=plan: JEngine(_jcfg(), JPlan(**plan)).mesh,
                    lambda plan=plan: _engine(**plan).mesh, JPlanError)


def test_explicit_mesh_errors_match_the_reference():
    _same_error(lambda: JEngine(_jcfg(), JPlan(mode="mesh", tenants=4),
                                mesh=jmesh.make_host_mesh()),
                lambda: DAEFEngine(_tcfg(), ExecutionPlan(mode="mesh", tenants=4),
                                   mesh=tmesh.make_host_mesh(device="cpu")), JPlanError)
    _same_error(lambda: JEngine(_jcfg(), JPlan(), mesh=jmesh.make_host_mesh()),
                lambda: DAEFEngine(_tcfg(), ExecutionPlan(),
                                   mesh=tmesh.make_host_mesh(device="cpu")), JPlanError)
    x = _xs(2, 16, 91)
    _same_error(lambda: JEngine(_jcfg(), JPlan(mode="mesh", mesh_axes=("data",))).fit(
                    jnp.asarray(x)),
                lambda: _engine(mode="mesh", mesh_axes=("data",)).fit(x), JPlanError)
    _same_error(lambda: JEngine(_jcfg(), JPlan(mode="mesh", mesh_axes=("data",))).fit_stream(
                    [jnp.asarray(x[0])]),
                lambda: _engine(mode="mesh", mesh_axes=("data",)).fit_stream([x[0]]),
                JPlanError)


@functools.lru_cache(maxsize=None)
def _fleets(seeds: tuple, lam_last: tuple = (LAM_LAST,) * 4):
    xs = _xs(4, 16, 93)
    jfl = jfleet._fit_fleet(_jcfg(), jnp.asarray(xs), seeds=jnp.asarray(seeds, jnp.int32),
                            lam_hidden=None, lam_last=jnp.asarray(lam_last, jnp.float32))
    tfl = tfleet._fit_fleet(_tcfg(), xs, seeds=np.asarray(seeds, np.int32),
                            lam_last=np.asarray(lam_last, np.float32), device="cpu")
    return jfl, tfl


@pytest.mark.parametrize("case", ["not a power of two", "does not divide", "group seeds",
                                  "group lambdas", "no tenants axis"])
def test_fleet_merge_tree_errors_match_the_reference(case):
    seeds = (0, 0, 1, 1) if case != "group seeds" else (0, 1, 2, 2)
    lams = (LAM_LAST,) * 4 if case != "group lambdas" else (0.9, 0.8, 0.9, 0.9)
    jfl, tfl = _fleets(seeds, lams)
    group = {"not a power of two": 3, "does not divide": 8}.get(case, 2)
    jkw, tkw = {}, {}
    if case == "no tenants axis":
        jkw = dict(mesh=jmesh.make_host_mesh())
        tkw = dict(mesh=tmesh.make_host_mesh(device="cpu"))
    _same_error(lambda: jfs.fleet_merge_tree(_jcfg(), jfl, group, **jkw),
                lambda: tfs.fleet_merge_tree(_tcfg(), tfl, group, **tkw))


@pytest.mark.parametrize("case", ["svd", "slots", "mask shape", "all masked"])
def test_merge_state_tree_errors_match_the_reference(case):
    jfl, tfl = _fleets((0, 0, 0, 0))
    s = 3 if case == "slots" else 4
    mask = {"mask shape": np.ones(3), "all masked": np.zeros(4)}.get(case, np.ones(s))
    cfg = "svd" if case == "svd" else "gram"

    def states(fl, lib):
        m = fl.model
        return lib(m.encoder_factors, m.layer_knowledge)

    jenc, jknw = states(jfl, lambda e, k: (type(e)(e.u[:s], e.s[:s]),
                                           tuple(type(x)(*(y[:s] for y in x)) for x in k)))
    tenc, tknw = states(tfl, lambda e, k: (type(e)(e.u[:s], e.s[:s]),
                                           tuple(type(x)(*(y[:s] for y in x)) for x in k)))
    _same_error(lambda: jfs.merge_state_tree(_jcfg(cfg), jenc, jknw, mask),
                lambda: tfs.merge_state_tree(_tcfg(cfg), tenc, tknw, mask))


def test_merge_state_tree_masks_slots_out():
    _, tfl = _fleets((0, 0, 0, 0))
    m = tfl.model
    enc, knw = tfs.merge_state_tree(_tcfg(), m.encoder_factors, m.layer_knowledge,
                                    np.array([1, 1, 0, 1], np.float32))
    jfl, _ = _fleets((0, 0, 0, 0))
    jm = jfl.model
    jenc, jknw = jfs.merge_state_tree(_jcfg(), jm.encoder_factors, jm.layer_knowledge,
                                      np.array([1, 1, 0, 1], np.float32))
    for t, j in zip(tfleet._tree_leaves((enc, knw)), jax.tree.leaves((jenc, jknw)), strict=True):
        assert_close(t, np.asarray(j), atol=1e-4 * max(1.0, float(np.abs(np.asarray(j)).max())))
    keep = [0, 1, 3]
    g = sum(m.layer_knowledge[0].g[i] for i in keep)
    assert_close(knw[0].g, g, atol=1e-4 * float(g.abs().max()))
