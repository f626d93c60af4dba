"""repro_torch.privacy (spec, accounting, secagg) and the port session's
secure-aggregation rounds against repro.privacy (tests/test_privacy.py
without the DP release and the threat demo, which tests/test_torch_dp.py
holds to the reference).

* ``PrivacySpec`` validation: the same error type and message as the
  reference's for every bad spec; plan checks likewise.
* ``PrivacyLedger``: the same totals under both compositions, the same
  refusals and messages, the same serialisation.
* ``secagg``: the fixed-point wires, the pairwise masks, ``unmask_dropout``
  and every ``aggregate`` strategy are bit-identical to the reference's on
  the same inputs; masked aggregates decode bit-identical to the unmasked
  sum.
* Sessions: a disabled spec is bit-exact with no spec; a secagg round
  matches the reference's secagg round and the unmasked round (TOLS for
  the weights through ``assert_models_match``; the reference's own bar
  against its unmasked round is 5e-4 / 1e-3); the async single-aggregate
  ledger, repeated reports, and persistence (a session's privacy spend
  history, saved by the reference, restores in the port).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match

from repro.core import daef as jdaef
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.privacy import PrivacyLedger as JLedger
from repro.privacy import PrivacySpec as JSpec
from repro.privacy import secagg as jsec
from repro_torch.core import daef as tdaef
from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError
from repro_torch.engine.session import SECAGG_AGGREGATE
from repro_torch.privacy import (PrivacyBudgetExceeded, PrivacyError, PrivacyLedger,
                                 PrivacySpec, accounting, secagg)

M0, LATENT = 9, 3
LAYERS = (M0, LATENT, 5, 7, M0)
LAM_LAST = 0.9
MODES = ("loop", "vmap")


def _kw(**kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method="gram",
                     stats_backend="einsum"), **kw)


def _tcfg(**kw):
    return tdaef.DAEFConfig(**_kw(**kw))


def _jcfg(**kw):
    return jdaef.DAEFConfig(**_kw(**kw))


def _engine(**plan):
    return DAEFEngine(_tcfg(), ExecutionPlan(**plan), device="cpu")


@functools.lru_cache(maxsize=None)
def _parts(n_sites=4, n=60, seed=0):
    """tests/test_privacy.py's site data: low rank, small values."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(M0, LATENT))
    out = []
    for _ in range(n_sites):
        p = (mix @ rng.normal(size=(LATENT, n)) * 0.4
             + 0.05 * rng.normal(size=(M0, n))).astype(np.float32)
        p.flags.writeable = False
        out.append(p)
    return tuple(out)


def _j(parts):
    if isinstance(parts, dict):
        return {k: jnp.asarray(v) for k, v in parts.items()}
    return [jnp.asarray(p) for p in parts]


# ---------------------------------------------------------------------------
# PrivacySpec and the plan's privacy checks
# ---------------------------------------------------------------------------

BAD_SPECS = [dict(epsilon=0.0), dict(epsilon=-1.0), dict(delta=0.0), dict(delta=1.0),
             dict(clip=0.0), dict(composition="nope"), dict(frac_bits=0), dict(frac_bits=41),
             dict(frac_bits=2.5), dict(budget_epsilon=4.0), dict(budget_delta=1e-3),
             dict(epsilon=1.0, budget_epsilon=0.0), dict(epsilon=1.0, budget_delta=-1.0)]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=[str(k) for k in BAD_SPECS])
def test_bad_spec_raises_as_the_reference(kw):
    with pytest.raises(ValueError) as jerr:
        JSpec(**kw)
    with pytest.raises(PrivacyError) as terr:
        PrivacySpec(**kw)
    assert type(terr.value).__name__ == type(jerr.value).__name__ == "PrivacyError"
    assert str(terr.value) == str(jerr.value)


def test_spec_properties_and_hash():
    spec = PrivacySpec()
    assert not spec.dp_enabled and not spec.secagg and not spec.enabled
    assert PrivacySpec(secagg=True).enabled and not PrivacySpec(secagg=True).dp_enabled
    assert PrivacySpec(epsilon=1.0).dp_enabled
    assert hash(PrivacySpec(secagg=True)) == hash(PrivacySpec(secagg=True))
    ref = JSpec()
    for field in ("epsilon", "delta", "clip", "secagg", "budget_epsilon", "budget_delta",
                  "composition", "frac_bits"):
        assert getattr(spec, field) == getattr(ref, field)


def test_plan_privacy_checks():
    with pytest.raises(PlanError, match="PrivacySpec"):
        ExecutionPlan(privacy={"epsilon": 1.0})
    with pytest.raises(PlanError, match="sequential"):
        ExecutionPlan(merge="sequential", privacy=PrivacySpec(secagg=True))
    ExecutionPlan(merge="sequential", privacy=PrivacySpec())
    with pytest.raises(PlanError, match="max_staleness"):
        ExecutionPlan(federation="async", merge="pairwise", max_staleness=1,
                      privacy=PrivacySpec(secagg=True))
    with pytest.raises(PlanError, match="gram"):
        DAEFEngine(_tcfg(method="svd"), ExecutionPlan(merge="pairwise",
                                                      privacy=PrivacySpec(secagg=True)),
                   device="cpu")
    with pytest.raises(PlanError, match="logsig"):
        DAEFEngine(_tcfg(act_hidden="relu"),
                   ExecutionPlan(merge="pairwise", privacy=PrivacySpec(epsilon=1.0)),
                   device="cpu")


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("composition", ["basic", "advanced"])
@pytest.mark.parametrize("spends", [[(1.0, 1e-6)] * 3, [(0.1, 1e-7)] * 100,
                                    [(0.5, 1e-6), (2.0, 1e-5), (0.01, 0.0)]],
                         ids=["three", "hundred small", "mixed"])
def test_ledger_totals_match_the_reference(composition, spends):
    ours, ref = PrivacyLedger(composition=composition), JLedger(composition=composition)
    for eps, delta in spends:
        ours.spend(eps, delta)
        ref.spend(eps, delta)
        assert ours.spent() == ref.spent()
    assert ours.releases == ref.releases and repr(ours) == repr(ref)
    clone = PrivacyLedger.from_spends(ours.spends(), composition=composition)
    assert clone.spent() == ours.spent()


def test_ledger_refusals_match_the_reference():
    for budget in (dict(budget_epsilon=2.5), dict(budget_delta=2.5e-6)):
        ours = PrivacyLedger(composition="basic", **budget)
        ref = JLedger(composition="basic", **budget)
        for led in (ours, ref):
            led.spend(1.0, 1e-6)
            led.spend(1.0, 1e-6)
        with pytest.raises(PrivacyBudgetExceeded) as terr:
            ours.spend(1.0, 1e-6)
        with pytest.raises(Exception) as jerr:
            ref.spend(1.0, 1e-6)
        assert str(terr.value) == str(jerr.value)
        assert ours.releases == 2 and ours.spent() == ref.spent()
    with pytest.raises(ValueError, match="unknown composition"):
        PrivacyLedger(composition="renyi")
    assert accounting.ADVANCED_SLACK == 1e-9


# ---------------------------------------------------------------------------
# Secure aggregation primitives: bit-identical to the reference
# ---------------------------------------------------------------------------

def _leaves(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=50.0, size=(4, 5)).astype(np.float64) for _ in range(n)]


def _same(a_wire, b_wire):
    assert len(a_wire) == len(b_wire)
    for a, b in zip(a_wire, b_wire, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frac_bits", [1, 20, 40])
def test_codec_bit_identical(frac_bits):
    leaves = _leaves(seed=frac_bits)
    wire = secagg.encode(leaves, frac_bits)
    _same(wire, jsec.encode(leaves, frac_bits))
    dtypes = [np.float64, np.float32, np.float64]
    _same(secagg.decode(wire, frac_bits, dtypes=dtypes), jsec.decode(wire, frac_bits,
                                                                   dtypes=dtypes))
    _same(secagg.decode(wire, frac_bits), jsec.decode(wire, frac_bits))
    q = 2.0 ** -20
    grid = [np.array([[1.5, -2.25], [q * 7, 0.0]])]
    np.testing.assert_array_equal(
        secagg.decode(secagg.encode(grid, 20), 20, dtypes=[np.float64])[0], grid[0])


def test_codec_refusals_match_the_reference():
    for bad in ([np.array([2.0 ** 45])], [np.array([np.nan])], [np.array([np.inf])]):
        with pytest.raises(secagg.SecAggError) as terr:
            secagg.encode(bad, 20)
        with pytest.raises(jsec.SecAggError) as jerr:
            jsec.encode(bad, 20)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(secagg.SecAggError, match="zero wires"):
        secagg.aggregate([])
    with pytest.raises(secagg.SecAggError, match="unknown aggregation strategy"):
        secagg.aggregate([secagg.encode(_leaves(), 20)], "butterfly")
    with pytest.raises(secagg.SecAggError, match="not among the participants"):
        secagg.mask_wire(secagg.encode(_leaves(), 20), "z", ["a", "b"], "s", 0)


@pytest.mark.parametrize("strategy", ["sequential", "pairwise", "tree"])
@pytest.mark.parametrize("n_sites", [2, 3, 5, 8])
def test_masks_and_aggregates_bit_identical(strategy, n_sites):
    sites = [f"site{i}" for i in range(n_sites)]
    wires = [secagg.encode(_leaves(seed=i), 20) for i in range(n_sites)]
    masked = [secagg.mask_wire(w, s, sites, "secret", 7) for s, w in zip(sites, wires)]
    jmasked = [jsec.mask_wire(w, s, sites, "secret", 7) for s, w in zip(sites, wires)]
    for a, b in zip(masked, jmasked, strict=True):
        _same(a, b)
    agg = secagg.aggregate(masked, strategy)
    _same(agg, jsec.aggregate(jmasked, strategy))
    plain = wires[0]
    for w in wires[1:]:
        plain = secagg.add_wires(plain, w)
    _same(agg, plain)  # the masks cancel exactly
    _same(secagg.decode(agg, 20, dtypes=[np.float64] * 3),
          secagg.decode(plain, 20, dtypes=[np.float64] * 3))


def test_pair_masks_and_dropout_recovery_bit_identical():
    sites = ["a", "b", "c", 4]
    template = secagg.encode(_leaves(), 20)
    _same(secagg.pair_mask("k", 3, "b", "a", template), jsec.pair_mask("k", 3, "a", "b",
                                                                          template))
    wires = [secagg.encode(_leaves(seed=i), 20) for i in range(4)]
    masked = [secagg.mask_wire(w, s, sites, "secret", 3) for s, w in zip(sites, wires)]
    agg = secagg.aggregate([masked[0], masked[1], masked[3]])
    fixed = secagg.unmask_dropout(agg, ["c"], ["a", "b", 4], "secret", 3)
    _same(fixed, jsec.unmask_dropout(agg, ["c"], ["a", "b", 4], "secret", 3))
    _same(fixed, secagg.aggregate([wires[0], wires[1], wires[3]]))
    single = secagg.mask_wire(wires[0], "a", ["a", "b"], "secret", 0)
    assert all(not np.array_equal(m, p) for m, p in zip(single, wires[0]))


# ---------------------------------------------------------------------------
# Sessions under the privacy tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("federation", ["sync", "async"])
def test_disabled_spec_bit_exact(mode, federation):
    kw = dict(mode=mode, federation=federation, merge="pairwise")
    plain = _engine(**kw).session().round(_parts())
    spec = _engine(privacy=PrivacySpec(), **kw).session().round(_parts())
    for a, b in zip(plain.weights, spec.weights, strict=True):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jsecagg(federation, merge):
    kw = dict(federation=federation, merge=merge)
    return JEngine(_jcfg(), JPlan(privacy=JSpec(secagg=True), **kw)).session().round(
        _j(_parts()))


@pytest.mark.parametrize("federation,merge", [("sync", "pairwise"), ("async", "sequential"),
                                              ("async", "pairwise")])
def test_secagg_round_matches_the_reference_and_the_unmasked_round(federation, merge):
    kw = dict(federation=federation, merge=merge)
    masked = _engine(privacy=PrivacySpec(secagg=True), **kw).session().round(_parts())
    assert_models_match(_jsecagg(federation, merge), masked, LAM_LAST)
    plain = _engine(**kw).session().round(_parts())
    for a, b in zip(masked.weights, plain.weights, strict=True):
        assert_close(a, b, atol=5e-4, rtol=1e-3)  # tests/test_privacy.py's bar
    assert masked.train_errors.shape == (256,)  # the histogram's resampled pool


def test_secagg_round_decodes_the_unmasked_sum_bit_for_bit(monkeypatch):
    """Inside a session round: the masked aggregate decodes to exactly the
    decoded sum of the unmasked wires."""
    seen = {}
    real_decode = secagg.decode

    def spy(wire, frac_bits, dtypes=None):
        seen["agg"] = [np.array(w) for w in wire]
        return real_decode(wire, frac_bits, dtypes)

    monkeypatch.setattr(secagg, "decode", spy)
    session = _engine(merge="pairwise", privacy=PrivacySpec(secagg=True)).session()
    session.round(_parts())
    from repro_torch.core import federated

    states = session._local_states([(i, torch.from_numpy(np.array(p)))
                                    for i, p in enumerate(_parts())])
    wires = [secagg.encode(federated.exchange_to_additive(session.engine.config, s), 20)
             for s in states]
    _same(seen["agg"], secagg.aggregate(wires))


def test_secagg_multi_round_sync():
    p1, p2 = _parts(seed=0), _parts(seed=1)
    s_plain = _engine(merge="pairwise").session()
    s_mask = _engine(merge="pairwise", privacy=PrivacySpec(secagg=True)).session()
    s_plain.round(p1)
    s_mask.round(p1)
    a, b = s_plain.round(p2), s_mask.round(p2)
    for wa, wb in zip(a.weights, b.weights, strict=True):
        assert_close(wa, wb, atol=5e-4, rtol=1e-3)


def test_async_secagg_single_aggregate_ledger():
    s = _engine(federation="async", merge="pairwise", privacy=PrivacySpec(secagg=True)).session()
    s.round({"a": _parts()[0], "b": _parts()[1]})
    s.round({"a": _parts()[2]})
    assert set(s.sites) == {SECAGG_AGGREGATE} and s._ledger[SECAGG_AGGREGATE].submits == 2


def test_secagg_tree_round_raises_naming_item_12():
    s = _engine(merge="tree", privacy=PrivacySpec(secagg=True)).session()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
        s.round(_parts())


def test_repeat_reports():
    parts = _parts(2)
    with pytest.raises(PlanError, match="twice"):
        _engine(merge="pairwise").session().round([("a", parts[0]), ("a", parts[1])])
    plan = dict(federation="async", merge="pairwise")
    s_dup = _engine(**plan).session()
    m_dup = s_dup.round([("a", parts[0]), ("a", parts[1])])
    assert s_dup._ledger["a"].submits == 2
    s_two = _engine(**plan).session()
    s_two.round({"a": parts[0]})
    m_two = s_two.round({"a": parts[1]})
    for a, b in zip(m_dup.weights, m_two.weights, strict=True):
        assert_close(a, b, atol=5e-4, rtol=1e-3)
    with pytest.raises(PlanError, match="secagg"):
        _engine(privacy=PrivacySpec(secagg=True), **plan).session().round(
            [("a", parts[0]), ("a", parts[1])])
    m_map = _engine(**plan).session().round({"a": parts[0], "b": parts[1]})
    m_pairs = _engine(**plan).session().round([("a", parts[0]), ("b", parts[1])])
    for a, b in zip(m_map.weights, m_pairs.weights, strict=True):
        assert torch.equal(a, b)


def test_session_persistence(tmp_path):
    engine = _engine(federation="async", merge="pairwise")
    s = engine.session()
    s.round({"a": _parts()[0], "b": _parts()[1]})
    s.round({"a": _parts()[2]})
    path = str(tmp_path / "sess")
    assert engine.save(s, path) == path
    s2 = engine.load(path)
    assert (s2.clock, s2.rounds_run, s2.sites) == (s.clock, s.rounds_run, s.sites)
    assert s2._ledger["a"].submits == 2 and isinstance(s2._ledger["a"].state[2], np.ndarray)
    ma, mb = s.round({"b": _parts()[3]}), s2.round({"b": _parts()[3]})
    for a, b in zip(ma.weights, mb.weights, strict=True):
        assert torch.equal(a, b)
    bad = engine.session()
    bad.round({("tuple", "id"): _parts()[0]})
    with pytest.raises(PlanError, match="int or str"):
        engine.save(bad, str(tmp_path / "bad"))


def test_reference_spend_history_restores_in_the_port(tmp_path):
    """A reference session's per-site privacy spend (the ledgers its DP
    releases fill; set here directly) restores in a port engine without
    DP: accounting is plain host state."""
    plan = dict(federation="async", merge="pairwise")
    jeng = JEngine(_jcfg(), JPlan(**plan))
    js = jeng.session()
    js.round(_j({"a": _parts()[0], "b": _parts()[1]}))
    js.round(_j({"a": _parts()[2]}))
    js._privacy_ledgers = {"a": JLedger.from_spends([(8.0, 1e-5), (8.0, 1e-5)]),
                           "b": JLedger.from_spends([(8.0, 1e-5)])}
    path = jeng.save(js, str(tmp_path / "dp"))
    ts = _engine(**plan).load(path)
    for site in ("a", "b", "never"):
        assert ts.privacy_spent(site) == js.privacy_spent(site)
    assert ts.privacy_spent("a")[0] > 0 and ts.sites == js.sites
    assert_models_match(js.round(_j({"b": _parts()[3]})), ts.round({"b": _parts()[3]}),
                        LAM_LAST)
    ts.reset()
    assert ts.privacy_spent("a") == js.privacy_spent("a")  # reset keeps the spend
