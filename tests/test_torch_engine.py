"""repro_torch.engine (DAEFEngine, ExecutionPlan) against repro.engine.

Mirrors tests/test_engine.py for the port's ``loop`` and ``vmap`` modes,
both methods and both stats backends (the port's fused backend through its
kernels' plain versions on the CPU; the reference on einsum, its fused
backend interprets Pallas on the CPU): fit, predict, scores, padding masks,
merge, reduce (sequential and pairwise), the session's round parity and
accumulation, the backend precedence, plan and input errors (the same type
and message as the reference's), save/load, and the deprecation shims.
Mesh plans and tree merges run since queue A item 12's DAEF part was
ported (tests/test_torch_mesh.py holds them to the reference; here the
two former refusals now run and match it); DP plans construct since item
11 was ported.

Models are held to the reference's by ``assert_models_match``
(tests/_torch_parity.py: TOLS, sums at 1e-4 of their max, the last layer
at the κ bar), reconstructions and scores at TOLS.  Data: 9-3-5-7-9 nets,
4 tenants of 120 samples, ``lowrank_data``.
"""
import dataclasses
import functools
import os
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, lowrank_data

from repro.core import daef as jdaef
from repro.core import federated as jfed
from repro.core import fleet as jfleet
from repro.core import rolann as jrol
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.engine import PlanError as JPlanError
from repro.privacy import PrivacySpec as JSpec
from repro_torch.core import daef as tdaef
from repro_torch.core import federated as tfed
from repro_torch.core import fleet as tfleet
from repro_torch.core import rolann as trol
from repro_torch.core import stats_backend
from repro_torch.engine import DAEFEngine, ExecutionPlan, FederationSession, PlanError, deprecation
from repro_torch.privacy import PrivacySpec

M0, LATENT, K, N = 9, 3, 4, 120
LAYERS = (M0, LATENT, 5, 7, M0)
LAM_LAST = 0.9
MODES = ("loop", "vmap")
BACKENDS = ("einsum", "fused")


def _kw(method="gram", backend="einsum", **kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method=method,
                     stats_backend=backend), **kw)


def _tcfg(method="gram", backend="einsum", **kw):
    return tdaef.DAEFConfig(**_kw(method, backend, **kw))


def _jcfg(method="gram", **kw):
    return jdaef.DAEFConfig(**_kw(method, "einsum", **kw))


def _engine(cfg=None, **plan):
    return DAEFEngine(cfg or _tcfg(), ExecutionPlan(**plan), device="cpu")


@functools.lru_cache(maxsize=None)
def _xs(k=K, n=N, seed=0):
    xs = np.stack([lowrank_data(M0, LATENT, n, seed=seed + 100 * t) for t in range(k)])
    xs.flags.writeable = False
    return xs


@functools.lru_cache(maxsize=None)
def _jfit(method, seed, data_seed, n=N, i=0, lam_hidden=None):
    kw = {} if lam_hidden is None else {"lam_hidden": lam_hidden}
    cfg = dataclasses.replace(_jcfg(method), seed=seed, **kw)
    return jdaef.fit(cfg, jnp.asarray(_xs(n=n, seed=data_seed)[i]))


def _as_gram(model):
    """A model of either package with factor knowledge in Gram form."""
    if hasattr(model.layer_knowledge[0], "u"):
        lib = trol if isinstance(model, tdaef.DAEFModel) else jrol
        return model._replace(layer_knowledge=tuple(
            lib.factors_to_stats(k) for k in model.layer_knowledge))
    return model


def _match(jm, tm, lam_last=LAM_LAST):
    assert_models_match(_as_gram(jm), _as_gram(tm), lam_last)


# ---------------------------------------------------------------------------
# fit / predict / scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_fit_predict_scores_parity(mode, backend):
    engine = _engine(_tcfg("gram", backend), mode=mode, tenants=K)
    xs = _xs()
    fl = engine.fit(xs, seeds=np.arange(K))
    assert isinstance(fl, tfleet.DAEFFleet) and fl.size == K
    assert fl.seeds.dtype == torch.int32
    recon, scores = engine.predict(fl, xs), engine.scores(fl, xs)
    assert engine.model_version == 1
    for i in range(K):
        ref = _jfit("gram", i, 0, i=i)
        cfg_i = dataclasses.replace(_jcfg(), seed=i)
        _match(ref, engine.get_model(fl, i))
        assert_close(recon[i], jdaef.predict(cfg_i, ref, jnp.asarray(xs[i])))
        assert_close(scores[i], jdaef.reconstruction_error(cfg_i, ref, jnp.asarray(xs[i])))


@pytest.mark.parametrize("mode", MODES)
def test_fit_parity_svd_method(mode):
    engine = _engine(_tcfg("svd"), mode=mode, tenants=K)
    fl = engine.fit(_xs(seed=3), seeds=np.arange(K))
    for i in range(K):
        _match(_jfit("svd", i, 3, i=i), engine.get_model(fl, i))


def test_scores_mask_padding_all_modes():
    n = N
    xs = _xs(n=n, seed=5)
    n_valid = np.asarray([n, 1, n // 2, n - 1])
    ref = JEngine(_jcfg(), JPlan(mode="vmap", tenants=K))
    want = np.asarray(ref.scores(ref.fit(jnp.asarray(xs)), jnp.asarray(xs), n_valid=n_valid))
    for mode in MODES:
        engine = _engine(mode=mode, tenants=K)
        s = engine.scores(engine.fit(xs), xs, n_valid=n_valid).numpy()
        for t in range(K):
            assert np.isfinite(s[t, : n_valid[t]]).all()
            assert np.isnan(s[t, n_valid[t]:]).all()
        assert_close(np.nan_to_num(s), np.nan_to_num(want))


def test_single_model_modes_match_direct_fit():
    x = _xs(k=1, n=96, seed=7)[0]
    ref = jdaef.fit(_jcfg(), jnp.asarray(x), n_partitions=2)
    for mode in MODES:
        engine = _engine(mode=mode, tenants=1)
        model = engine.fit(x, n_partitions=2)
        assert isinstance(model, tdaef.DAEFModel)
        _match(ref, model)
        assert_close(engine.scores(model, x),
                     jdaef.reconstruction_error(_jcfg(), ref, jnp.asarray(x)))
        # the engine's fit is the module-level fit, bit for bit
        direct = tdaef.fit(_tcfg(), x, n_partitions=2, device="cpu")
        for a, b in zip(model.weights, direct.weights, strict=True):
            assert torch.equal(a, b)
    x2 = _xs(k=1, n=48, seed=8)[0]
    engine = _engine()
    upd = engine.partial_fit(engine.fit(x), x2)
    jref = jdaef.partial_fit(_jcfg(), jdaef.fit(_jcfg(), jnp.asarray(x)), jnp.asarray(x2))
    _match(jref, upd)
    assert engine.model_version == 2


@functools.lru_cache(maxsize=None)
def _jchunked():
    """The reference's chunked fleet fit and its partial fit (its vmap plan;
    its loop plan agrees with it to float32 rounding)."""
    jeng = JEngine(_jcfg(), JPlan(mode="vmap", tenants=K, chunk_samples=50))
    jfl = jeng.fit(jnp.asarray(_xs(seed=9)), seeds=jnp.arange(K, dtype=jnp.int32))
    return jfl, jeng.partial_fit(jfl, jnp.asarray(_xs(seed=10)))


@pytest.mark.parametrize("mode", MODES)
def test_chunked_and_streamed_plans_match_the_reference(mode):
    xs = _xs(seed=9)
    engine = _engine(mode=mode, tenants=K, chunk_samples=50)
    seeds = np.arange(K, dtype=np.int32)
    jfl, jupd = _jchunked()
    fl = engine.fit(xs, seeds=seeds)
    chunks = [xs[..., i:i + 50] for i in range(0, N, 50)]
    streamed = engine.fit_stream(chunks, seeds=seeds)
    upd = engine.partial_fit(fl, _xs(seed=10))
    for i in range(K):
        jm = jfleet.get_model(jfl, i)
        _match(jm, tfleet.get_model(fl, i))
        _match(jm, tfleet.get_model(streamed, i))
        _match(jfleet.get_model(jupd, i), tfleet.get_model(upd, i))
    one = _engine(chunk_samples=50)
    _match(jdaef.fit_chunked(_jcfg(), jnp.asarray(xs[0]), chunk_samples=50),
           one.fit_stream(lambda: iter(chunks_0 for chunks_0 in (c[0] for c in chunks))))


# ---------------------------------------------------------------------------
# merge / reduce / federation rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_merge_parity(mode):
    engine = _engine(mode=mode, tenants=K)
    fa = engine.fit(_xs(seed=1), seeds=np.arange(K))
    fb = engine.fit(_xs(seed=101), seeds=np.arange(K))
    merged = engine.merge(fa, fb)
    for i in range(K):
        cfg_i = dataclasses.replace(_jcfg(), seed=i)
        ref = jdaef.merge_models(cfg_i, _jfit("gram", i, 1, i=i), _jfit("gram", i, 101, i=i))
        _match(ref, engine.get_model(merged, i))


@pytest.mark.parametrize("mode", MODES)
def test_merge_rejects_mismatched_seeds_in_every_mode(mode):
    engine = _engine(mode=mode, tenants=2)
    xs = _xs(k=2, n=40, seed=2)
    fa = engine.fit(xs, seeds=np.arange(2))
    fb = engine.fit(xs, seeds=np.arange(2) + 100)
    with pytest.raises(ValueError, match="different per-tenant seeds"):
        engine.merge(fa, fb)


def test_for_tenants_serves_reduced_fleet():
    k, group = 8, 4
    xs = _xs(k=k, n=40, seed=4)
    engine = _engine(mode="vmap", tenants=k, merge="pairwise")
    fl = engine.fit(xs, seeds=np.repeat(np.arange(k // group), group))
    sites = engine.reduce(fl, group)
    with pytest.raises(PlanError, match="fleet has 2 tenants"):
        engine.scores(sites, xs[: k // group])
    derived = engine.for_tenants(sites.size)
    assert derived.plan.tenants == sites.size and derived.device == engine.device
    assert derived.plan.mode == "vmap" and derived.plan.merge == "pairwise"
    s = derived.scores(sites, xs[: k // group])
    assert tuple(s.shape) == (k // group, 40)
    mus = derived.thresholds(sites, rule="q90")
    assert derived.classify(s, mus).shape == s.shape


@pytest.mark.parametrize("merge", ["sequential", "pairwise"])
def test_reduce_matches_the_reference(merge):
    k, group = 8, 4
    xs = _xs(k=k, seed=11)
    seeds = np.repeat(np.arange(k // group), group).astype(np.int32)
    jeng = JEngine(_jcfg(), JPlan(mode="vmap", tenants=k, merge=merge))
    jred = jeng.reduce(jeng.fit(jnp.asarray(xs), seeds=jnp.asarray(seeds)), group)
    engine = _engine(mode="vmap", tenants=k, merge=merge)
    red = engine.reduce(engine.fit(xs, seeds=seeds), group)
    assert red.size == k // group and torch.equal(red.seeds, torch.tensor([0, 1], dtype=torch.int32))
    for i in range(k // group):
        _match(jfleet.get_model(jred, i), tfleet.get_model(red, i))


def test_reduce_sequential_and_pairwise_agree():
    xs = _xs(k=8, seed=12)
    seeds = np.zeros(8, np.int32)
    out = {}
    for merge in ("sequential", "pairwise"):
        engine = _engine(mode="vmap", tenants=8, merge=merge)
        out[merge] = engine.reduce(engine.fit(xs, seeds=seeds), 8)
    assert_models_match(tfleet.get_model(out["sequential"], 0), tfleet.get_model(out["pairwise"], 0),
                        LAM_LAST)


@pytest.mark.parametrize("merge", ["sequential", "pairwise"])
@pytest.mark.parametrize("method", ["gram", "svd"])
def test_session_round_parity(merge, method):
    x = _xs(k=1, n=240, seed=13)[0]
    bounds = (0, 60, 120, 180, 240)
    parts = [x[:, a:b] for a, b in zip(bounds, bounds[1:])]
    session = _engine(_tcfg(method), merge=merge).session()
    assert isinstance(session, FederationSession)
    agg = session.round(parts)
    assert session.rounds_run == 1 and session.engine.model_version == 1
    jagg = JEngine(_jcfg(method), JPlan(merge=merge)).session().round(
        [jnp.asarray(p) for p in parts])
    _match(jagg, agg)
    if merge == "sequential":
        direct = tfed._federated_fit(_tcfg(method), parts, device="cpu")
        for a, b in zip(agg.weights, direct.weights, strict=True):
            assert torch.equal(a, b)


def test_session_accumulates_across_rounds():
    xa, xb = _xs(k=1, seed=17)[0], _xs(k=1, seed=18)[0]
    session = _engine(merge="sequential").session()
    first = session.round([xa[:, :60], xa[:, 60:]])
    second = session.round([xb[:, :60], xb[:, 60:]])
    assert session.rounds_run == 2
    ref = tdaef.merge_models(
        _tcfg(),
        tfed._federated_fit(_tcfg(), [xa[:, :60], xa[:, 60:]], device="cpu"),
        tfed._federated_fit(_tcfg(), [xb[:, :60], xb[:, 60:]], device="cpu"),
    )
    for a, b in zip(second.weights, ref.weights, strict=True):
        assert torch.equal(a, b)
    js = JEngine(_jcfg(), JPlan(merge="sequential")).session()
    js.round([jnp.asarray(xa[:, :60]), jnp.asarray(xa[:, 60:])])
    _match(js.round([jnp.asarray(xb[:, :60]), jnp.asarray(xb[:, 60:])]), second)
    session.reset()
    assert session.rounds_run == 0 and session.model is None
    again = session.round([xa[:, :60], xa[:, 60:]])
    for a, b in zip(again.weights, first.weights, strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# stats-backend precedence (plan > config > env > default)
# ---------------------------------------------------------------------------

def test_stats_backend_precedence():
    cfg = _tcfg(backend=None)
    with mock.patch.dict(os.environ, {stats_backend.ENV_VAR: "fused"}):
        assert _engine(cfg).config.stats_backend == "fused"
        assert _engine(_tcfg(backend="einsum")).config.stats_backend == "einsum"
        eng = DAEFEngine(_tcfg(backend="fused"), ExecutionPlan(stats_backend="einsum"),
                         device="cpu")
        assert eng.config.stats_backend == "einsum" and eng.plan.stats_backend == "einsum"
    with mock.patch.dict(os.environ, {stats_backend.ENV_VAR: "einsum"}):
        eng = _engine(cfg)
    assert eng.config.stats_backend == "einsum"
    with mock.patch.dict(os.environ, {stats_backend.ENV_VAR: "nonsense"}):
        with pytest.raises(ValueError, match="unknown stats backend"):
            _engine(cfg)
    env = {k: v for k, v in os.environ.items() if k != stats_backend.ENV_VAR}
    with mock.patch.dict(os.environ, env, clear=True):
        # "auto" (the default) resolves to the host's measured verdict, einsum
        assert _engine(cfg).config.stats_backend == "einsum"
        assert DAEFEngine(cfg, ExecutionPlan(stats_backend="fused"),
                          device="cpu").config.stats_backend == "fused"


def test_backend_parity_through_engine():
    xs = _xs(seed=19)
    fls = {b: _engine(mode="vmap", tenants=K, stats_backend=b).fit(xs, seeds=np.arange(K))
           for b in BACKENDS}
    for i in range(K):
        assert_models_match(tfleet.get_model(fls["einsum"], i), tfleet.get_model(fls["fused"], i),
                            LAM_LAST)


# ---------------------------------------------------------------------------
# plan and input errors: the reference's type and message
# ---------------------------------------------------------------------------

BAD_PLANS = {
    "mode": dict(mode="warp"),
    "merge": dict(merge="blend"),
    "federation": dict(federation="eventually"),
    "tenants": dict(tenants=0),
    "staleness sign": dict(federation="async", max_staleness=-1),
    "staleness sync": dict(max_staleness=2),
    "mesh size": dict(mode="mesh", tenants=5, mesh_devices=3),
    "mesh devices": dict(mode="vmap", mesh_devices=2),
    "mesh devices 0": dict(mode="mesh", mesh_devices=0),
    "mesh axes": dict(mode="mesh", mesh_axes=()),
    "single model": dict(mode="mesh", tenants=4, mesh_axes=("data",)),
    "factorization": dict(local_factorization="qr"),
    "chunk": dict(chunk_samples=0),
    "chunk on data mesh": dict(mode="mesh", mesh_axes=("data",), chunk_samples=8),
    "backend": dict(stats_backend="nonsense"),
    "privacy type": dict(privacy={"epsilon": 1.0}),
    "privacy sequential": dict(merge="sequential", privacy="secagg"),
    "secagg staleness": dict(federation="async", merge="pairwise", max_staleness=1,
                             privacy="secagg"),
}


@pytest.mark.parametrize("name", sorted(BAD_PLANS))
def test_plan_validation_errors_match_the_reference(name):
    kw = BAD_PLANS[name]

    def plan(cls, spec):
        args = dict(kw)
        if args.get("privacy") == "secagg":
            args["privacy"] = spec(secagg=True)
        return cls(**args)

    with pytest.raises(ValueError) as jerr:
        plan(JPlan, JSpec)
    with pytest.raises(ValueError) as terr:
        plan(ExecutionPlan, PrivacySpec)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


def test_plans_are_data():
    plan = ExecutionPlan(mode="mesh", tenants=8, mesh_devices=4, merge="tree",
                         mesh_axes="tenants")
    assert plan.mesh_axes == ("tenants",) and plan.tenant_sharded and not plan.data_sharded
    assert ExecutionPlan(mode="mesh", mesh_axes=("data",)).data_sharded
    assert hash(plan) == hash(dataclasses.replace(plan))
    assert ExecutionPlan(federation="async", max_staleness=3).async_federation
    ExecutionPlan(merge="sequential", privacy=PrivacySpec())  # a disabled spec is fine


@functools.lru_cache(maxsize=None)
def _error_calls(lib: str) -> dict:
    """The calls that must fail, on one package's engines ("j": the
    reference, "t": the port on the CPU)."""
    if lib == "j":
        make, plan, cfg, arr = JEngine, JPlan, _jcfg, jnp.asarray
    else:
        def make(c, p=None):
            return DAEFEngine(c, p, device="cpu")
        plan, cfg, arr = ExecutionPlan, _tcfg, np.asarray
    xs, x6 = arr(_xs(k=K, n=60, seed=21)), arr(_xs(k=6, n=60, seed=24))
    eng_k, eng_1 = make(cfg(), plan(mode="vmap", tenants=K)), make(cfg(), plan())
    fl, m1, f1 = eng_k.fit(xs), eng_1.fit(xs[0]), eng_1.fit(xs[:1])
    fl_seeded = eng_k.fit(xs, seeds=arr(np.arange(K, dtype=np.int32)))
    eng_6 = make(cfg(), plan(mode="vmap", tenants=6, merge="pairwise"))
    fl6 = eng_6.fit(x6, seeds=arr(np.zeros(6, np.int32)))
    loop = make(cfg(), plan(mode="loop", tenants=K))
    return {
        "tenants": lambda: eng_k.fit(xs[:2]),
        "feature dim": lambda: eng_k.fit(xs[:, :3, :]),
        "stack": lambda: eng_k.fit(xs[0]),
        "1-D": lambda: eng_k.fit(xs[0, 0]),
        "per-tenant": lambda: eng_1.fit(xs[0], seeds=3),
        "n_partitions": lambda: make(cfg(), plan(chunk_samples=8)).fit(xs[0], n_partitions=2),
        "n_valid": lambda: eng_1.scores(m1, xs[0], n_valid=[3]),
        "stream svd": lambda: make(cfg("svd")).fit_stream([xs[0]]),
        "stream seeds": lambda: eng_1.fit_stream([xs[0]], seeds=2),
        "empty stream": lambda: loop.fit_stream([]),
        "stream shape": lambda: loop.fit_stream([xs[0]]),
        "state kind": lambda: eng_1.scores(fl, xs),
        "model on fleet plan": lambda: eng_k.scores(m1, xs),
        "not a state": lambda: eng_1.get_model({"w": 1}),
        "mix": lambda: eng_1.merge(m1, f1),
        "mix reversed": lambda: eng_1.merge(f1, m1),
        "single reduce": lambda: eng_1.reduce(m1, 2),
        "divide": lambda: eng_k.reduce(fl, 3),
        "power of two": lambda: eng_6.reduce(fl6, 3),
        "group seeds": lambda: eng_k.reduce(fl_seeded, 2),
    }


@pytest.mark.parametrize("case", sorted([
    "tenants", "feature dim", "stack", "1-D", "per-tenant", "n_partitions", "n_valid",
    "stream svd", "stream seeds", "empty stream", "stream shape", "state kind",
    "model on fleet plan", "not a state", "mix", "mix reversed", "single reduce", "divide",
    "power of two", "group seeds"]))
def test_engine_input_errors_match_the_reference(case):
    with pytest.raises(ValueError) as jerr:
        _error_calls("j")[case]()
    with pytest.raises(ValueError) as terr:
        _error_calls("t")[case]()
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


def test_save_load_errors_and_bad_plan_type():
    with pytest.raises(PlanError, match="must be an ExecutionPlan"):
        DAEFEngine(_tcfg(), plan="vmap", device="cpu")
    with pytest.raises(PlanError, match="chunk_samples=8 streams"):
        DAEFEngine(_tcfg("svd"), ExecutionPlan(chunk_samples=8), device="cpu")
    with pytest.raises(PlanError, match="method='gram'"):
        DAEFEngine(_tcfg("svd"), ExecutionPlan(merge="pairwise",
                                               privacy=PrivacySpec(secagg=True)), device="cpu")
    with pytest.raises(PlanError, match="explicit mesh"):
        DAEFEngine(_tcfg(), ExecutionPlan(), mesh=object(), device="cpu")
    with pytest.raises(PlanError, match="expected a DAEFModel or DAEFFleet"):
        _engine().save({"w": 1}, "unused")
    assert isinstance(JPlanError("x"), ValueError) and issubclass(PlanError, ValueError)


# ---------------------------------------------------------------------------
# once waiting: mesh plans and tree merges (item 12); DP plans (item 11)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", [dict(mode="mesh", tenants=4),
                                  dict(mode="mesh", tenants=8, mesh_devices=4),
                                  dict(mode="mesh", mesh_axes=("data",))],
                         ids=["tenant mesh", "tenant mesh sized", "data mesh"])
def test_mesh_plans_raise_naming_item_12(plan):
    """Item 12's DAEF part is ported: a mesh plan builds the reference's
    one-device mesh in this one-rank process and fits as the reference's
    does; a plan sized past the one device raises the reference's
    ``PlanError``, word for word, as does a mesh missing the plan's axis."""
    from repro_torch.launch import mesh as tmesh

    if plan.get("mesh_devices"):
        with pytest.raises(JPlanError) as jerr:
            JEngine(_jcfg(), JPlan(**plan))
        with pytest.raises(PlanError) as terr:
            _engine(**plan)
        assert str(terr.value) == str(jerr.value)
        return
    engine, jengine = _engine(**plan), JEngine(_jcfg(), JPlan(**plan))
    assert engine.mesh.shape == dict(jengine.mesh.shape) and engine.device == torch.device("cpu")
    wrong = ("data",) if engine.plan.tenant_sharded else ("tenants",)
    with pytest.raises(PlanError) as terr:
        DAEFEngine(_tcfg(), ExecutionPlan(**plan), mesh=tmesh.Mesh((1,), wrong, device="cpu"))
    assert str(terr.value).startswith(f"mesh {{{wrong[0]!r}: 1}} has no axis")
    # the data of test_fit_predict_scores_parity and
    # test_single_model_modes_match_direct_fit (the reference's data-mesh
    # fit under jax.jit: its eager shard_map compiles op by op)
    if engine.plan.tenant_sharded:
        fl, jfl = engine.fit(_xs(), seeds=np.arange(K)), jengine.fit(
            jnp.asarray(_xs()), seeds=jnp.arange(K))
        for i in range(K):
            _match(jfleet.get_model(jfl, i), tfleet.get_model(fl, i))
    else:
        x = _xs(k=1, n=96, seed=7)[0]
        _match(jax.jit(jengine.fit)(jnp.asarray(x)), engine.fit(x))


def test_dp_plans_raise_naming_item_11():
    """Item 11 is ported: a DP plan constructs (tests/test_torch_dp.py holds
    its rounds to the reference) and nothing names the item any more; the
    reference's PlanErrors for a DP plan stay."""
    for plan in (dict(merge="pairwise", privacy=PrivacySpec(epsilon=1.0)),
                 dict(federation="async", privacy=PrivacySpec(epsilon=2.0, secagg=True))):
        engine = _engine(**plan)
        assert engine.plan.privacy.dp_enabled and engine.session().privacy_spent(0) == (0, 0)
    with pytest.raises(PlanError, match="logsig"):
        _engine(_tcfg(act_hidden="relu"), merge="pairwise", privacy=PrivacySpec(epsilon=1.0))


def test_tree_merges_raise_naming_item_12():
    """The tree merges run (item 12's DAEF part is ported) and match the
    reference's, every model that ``reduce`` returns; the reference's
    checks of a tree round stay, word for word.  Each tenant draws its own
    mixture, so the last layers are held at the larger of the κ bar and
    ``cancellation_bar`` (tests/_torch_parity.py)."""
    xs = _xs(k=4, n=40, seed=23)
    engine = _engine(mode="vmap", tenants=4, merge="tree")
    fl = engine.fit(xs, seeds=np.zeros(4, np.int32))
    jengine = JEngine(_jcfg(), JPlan(mode="vmap", tenants=4, merge="tree"))
    jfl = jengine.fit(jnp.asarray(xs), seeds=jnp.zeros(4, jnp.int32))
    got, want = engine.reduce(fl, 2), jengine.reduce(jfl, 2)
    assert got.size == 2
    for i in range(2):
        assert_models_match(jfleet.get_model(want, i), tfleet.get_model(got, i), LAM_LAST,
                            m_cancels=True)
    assert engine.reduce(fl, 1) is fl
    six = _engine(mode="vmap", tenants=6, merge="tree")
    with pytest.raises(PlanError, match="power-of-two"):
        six.reduce(six.fit(_xs(k=6, n=32, seed=24), seeds=np.zeros(6, np.int32)), 3)
    x = _xs(k=1, n=48, seed=25)[0]
    sess = _engine(merge="tree").session()
    # the reference's validation of a tree round, word for word, then the round
    jsess = JEngine(_jcfg(), JPlan(merge="tree")).session()
    for parts in ([x[:, :16], x[:, 16:32], x[:, 32:]], [x[:, :8], x[:, 8:]], []):
        with pytest.raises(JPlanError) as jerr:
            jsess.round([jnp.asarray(p) for p in parts])
        with pytest.raises(PlanError) as terr:
            sess.round(parts)
        assert str(terr.value) == str(jerr.value)
    halves = [x[:, :24], x[:, 24:]]
    _match(jsess.round([jnp.asarray(p) for p in halves]), sess.round(halves))
    assert sess.round([x]) is not None  # one node: a local fit, no tree
    asess = _engine(federation="async", merge="tree").session()
    jasess = JEngine(_jcfg(), JPlan(federation="async", merge="tree")).session()
    _match(jasess.round([jnp.asarray(p) for p in halves]), asess.round(halves))
    with pytest.raises(PlanError, match="needs\nmethod='gram'|method='gram'"):
        _engine(_tcfg("svd"), federation="async", merge="tree").session().round(
            [x[:, :24], x[:, 24:]])


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gram", "svd"])
@pytest.mark.parametrize("mode", MODES)
def test_save_load_roundtrip(method, mode, tmp_path):
    engine = _engine(_tcfg(method), mode=mode, tenants=K)
    fl = engine.fit(_xs(n=48, seed=27), seeds=np.arange(K))
    restored = engine.load(engine.save(fl, str(tmp_path / "fleet")))
    assert isinstance(restored, tfleet.DAEFFleet)
    for a, b in zip(jfleet_leaves(restored), jfleet_leaves(fl), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    single = _engine(_tcfg(method))
    model = single.fit(_xs(n=48, seed=27)[0])
    path = single.save(model, str(tmp_path / "model"))
    back = single.load(path)
    for a, b in zip(jfleet_leaves(back), jfleet_leaves(model), strict=True):
        assert torch.equal(a, b)
    other = DAEFEngine(tdaef.DAEFConfig(layer_sizes=(M0, 3, M0), method=method), device="cpu")
    with pytest.raises(PlanError, match="does not match"):
        other.load(path)


def jfleet_leaves(state):
    return tfleet._tree_leaves(state)


# ---------------------------------------------------------------------------
# deprecation shims: delegate to the engine, warn once
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_warnings():
    """Each shim warns once per process; the tier-1 run shares processes
    between files, so the set is saved, cleared and restored here."""
    saved = set(deprecation._WARNED)
    deprecation._WARNED.clear()
    yield
    deprecation._WARNED.clear()
    deprecation._WARNED.update(saved)


def test_fleet_fit_shim_delegates_and_warns_once(fresh_warnings):
    xs, seeds = _xs(n=48, seed=31), np.arange(K)
    want = _engine(mode="vmap", tenants=K).fit(xs, seeds=seeds)
    with pytest.warns(DeprecationWarning, match="fleet.fleet_fit is deprecated"):
        got = tfleet.fleet_fit(_tcfg(), xs, seeds=seeds, device="cpu")  # repro-lint: disable=RPR001
    for a, b in zip(jfleet_leaves(got), jfleet_leaves(want), strict=True):
        assert torch.equal(a, b)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tfleet.fleet_fit(_tcfg(), xs, seeds=seeds, device="cpu")  # repro-lint: disable=RPR001
        with pytest.raises(ValueError, match=r"fleet data must be \[K, m0, n\]"):
            tfleet.fleet_fit(_tcfg(), xs[0], device="cpu")  # repro-lint: disable=RPR001
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_federated_fit_shim_delegates_and_warns_once(fresh_warnings):
    x = _xs(k=1, seed=13)[0]
    parts = [x[:, :60], x[:, 60:]]
    with pytest.warns(DeprecationWarning, match="federated.federated_fit"):
        got = tfed.federated_fit(_tcfg(), parts, device="cpu")  # repro-lint: disable=RPR001
    want = tfed._federated_fit(_tcfg(), parts, device="cpu")
    for a, b in zip(got.weights, want.weights, strict=True):
        assert torch.equal(a, b)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tfed.federated_fit(_tcfg(), parts, device="cpu")  # repro-lint: disable=RPR001
    assert not rec
    jwant = jfed._federated_fit(_jcfg(), [jnp.asarray(p) for p in parts])
    _match(jwant, got)


def test_engine_defaults_to_the_card_and_keeps_states_on_its_device(monkeypatch):
    engine = _engine(mode="vmap", tenants=K)
    assert engine.device == torch.device("cpu") and "device=cpu" in repr(engine)
    fl = engine.fit(torch.from_numpy(np.array(_xs(n=40, seed=35))))
    assert all(leaf.device.type == "cpu" for leaf in jfleet_leaves(fl))
    assert engine.mesh is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        DAEFEngine(_tcfg(), ExecutionPlan())
