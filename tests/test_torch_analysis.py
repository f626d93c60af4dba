"""The port's analysis package (repro_torch.analysis) against the
reference's (repro.analysis), on the CPU.

* retrace: `trace_guard` counts the recorder's events — CUDA-graph
  captures as ``traces``, kernel-library loads (`kernels._build.load`'s
  opens) as ``compiles`` — cold, then warm, nested guards their own
  deltas, a budget raise naming what was captured; the reference's
  ``test_trace_guard_*`` claims, and its chunked-fit flatness claim
  (tests/test_streaming.py) through `_build.clear_loaded` (on the host no
  library loads: the counts are equal at 0; tests/test_torch_cuda.py's
  ``-k analysis`` holds them on the card, where kernels load and graphs
  capture).
* donation: `probe` on an in-place fold (effective), an allocating
  function (dropped), no request (``ok`` None); `DonationReport`'s fields
  are the reference's.
* lint: on every reference fixture whose rule the port carries as is
  (RPR001, RPR002's import-time half, RPR005, RPR006, RPR007's literal key
  and stdlib random) both linters find the same (line, rule) pairs; the
  re-targeted rules (RPR002 in a capture, RPR003, RPR004, RPR007's literal
  seeds) have fixtures of their own under tests/torch_lint_fixtures/ with
  the same ``# line N: RPRnnn`` markers, which the reference's linter finds
  clean; src/repro_torch lints clean with no baseline; the CLI's exit codes
  and the baseline round trip.
* the CLI's self-checks: ``retrace`` and ``donation`` exit 0 with
  ``--device cpu``; the retrace self-check's served scores equal the
  reference self-check's to 1e-5 and its flags agree off ties.
"""
import ast
import dataclasses
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)

from repro.analysis import donation as jdonation
from repro.analysis import lint as jlint
from repro_torch.analysis import donation, lint, retrace
from repro_torch.analysis.__main__ import RAGGED_REQUESTS, retrace_serve
from repro_torch.core import daef, fleet
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURES = REPO / "tests" / "torch_lint_fixtures"
MARKER_RE = re.compile(r"# line (\d+): (RPR\d{3})(?: x(\d+))?")
ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}

#: reference fixtures whose rule the port carries as is; RPR002's jit half
#: and RPR003/RPR004 (jit bodies) and RPR008 (Pallas) are not carried
CARRIED = ("rpr001_deprecated", "rpr002_env", "rpr005_warnings", "rpr006_time",
           "rpr007_privacy")


def expected_findings(path: Path) -> Counter:
    """(line, rule) -> count, from the fixture's own marker comments."""
    want: Counter = Counter()
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = MARKER_RE.search(line)
        if m:
            assert int(m.group(1)) == i, f"{path.name}: stale marker on {i}"
            want[(i, m.group(2))] += int(m.group(3) or 1)
    return want


def _pairs(findings) -> Counter:
    return Counter((f.line, f.rule) for f in findings)


# ---------------------------------------------------------------------------
# trace_guard
# ---------------------------------------------------------------------------

def _capturing(name):
    """A function that 'captures a graph' once per new shape, as the fleet
    server's tile graphs do: the jit cache's counterpart."""
    graphs = {}

    def call(x):
        if x.shape not in graphs:
            graphs[x.shape] = object()
            retrace.record(retrace.GRAPH_CAPTURE_EVENT, f"{name}{list(x.shape)}")
        return x * 2

    return call


def test_trace_guard_counts_cold_then_warm():
    poly = _capturing("poly")
    x = torch.arange(6.0).reshape(2, 3)
    with retrace.trace_guard() as cold:
        poly(x)
    assert cold.traces == 1 and cold.compiles == 0 and cold.traced_names == ["poly[2, 3]"]
    with retrace.trace_guard(max_traces=0) as warm:
        poly(x)
    assert warm.traces == 0 and warm.compiles == 0 and warm.traced_names == []


def test_trace_guard_budget_raises_with_names():
    fresh = _capturing("fresh_fn")
    with pytest.raises(retrace.TraceBudgetExceeded,
                       match=r"cold call: 1 CUDA-graph capture\(s\), budget 0; "
                             r"captured: \['fresh_fn\[3, 5\]'\]"):
        with retrace.trace_guard(max_traces=0, what="cold call"):
            fresh(torch.ones((3, 5)))


def test_trace_guard_nested_sees_own_deltas():
    g = _capturing("g")
    with retrace.trace_guard() as outer:
        g(torch.ones((4, 1)))
        with retrace.trace_guard(max_traces=0) as inner:
            g(torch.ones((4, 1)))  # warm inside
        with retrace.trace_guard() as second:
            g(torch.ones((4, 2)))
    assert (outer.traces, inner.traces, second.traces) == (2, 0, 1)
    assert str(second) == "TraceReport(traces=1, compiles=0 (g[4, 2]))"


def test_library_loads_count_first_opens(monkeypatch):
    """`_build.load` counts one load per library it opens: not again while
    loaded, again after `clear_loaded` (the reference's ``jax.clear_caches``
    for a cold count); a load over budget raises naming the library."""
    monkeypatch.setattr(_build, "build", lambda name: {name: Path(f"/nowhere/lib{name}.so")})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_LOADED", {})
    with retrace.trace_guard() as cold:
        a = _build.load("rolann_fused_chunk")
        assert _build.load("rolann_fused_chunk") is a
        _build.load("rolann_stats")
    assert (cold.traces, cold.compiles) == (0, 2)
    assert cold.traced_names == ["rolann_fused_chunk", "rolann_stats"]
    with retrace.trace_guard(max_compiles=0):
        _build.load("rolann_stats")
    _build.clear_loaded()
    with pytest.raises(retrace.TraceBudgetExceeded,
                       match=r"1 kernel-library load\(s\), budget 0; loaded: \['rolann_stats'\]"):
        with retrace.trace_guard(max_compiles=0):
            _build.load("rolann_stats")


def test_chunked_fit_load_count_flat_in_chunks():
    """The reference's flatness claim for `fleet._fit_fleet_chunked`: cold
    counts at chunk 32 and chunk 16 equal, a warm re-run free (on the host
    the fit opens no library and captures nothing)."""
    cfg = daef.DAEFConfig(layer_sizes=(6, 3, 4, 6), lam_hidden=0.9, lam_last=0.9,
                          stats_backend="fused")
    xs = np.random.default_rng(21).normal(size=(2, 6, 128)).astype(np.float32)
    counts = []
    for chunk in (32, 16):
        _build.clear_loaded()
        with retrace.trace_guard(what=f"chunk={chunk} cold") as rep:
            fleet._fit_fleet_chunked(cfg, xs, chunk_samples=chunk, seeds=np.arange(2),
                                     device="cpu")
        counts.append((rep.traces, rep.compiles))
    assert counts[0] == counts[1]
    with retrace.trace_guard(max_traces=0, max_compiles=0, what="chunk=16 warm"):
        fleet._fit_fleet_chunked(cfg, xs, chunk_samples=16, seeds=np.arange(2), device="cpu")


# ---------------------------------------------------------------------------
# donation probe
# ---------------------------------------------------------------------------

def test_donation_report_fields_are_the_references():
    names = [f.name for f in dataclasses.fields(donation.DonationReport)]
    assert names == [f.name for f in dataclasses.fields(jdonation.DonationReport)]
    for prop in ("ok", "dropped", "describe"):
        assert hasattr(donation.DonationReport, prop)


def test_probe_in_place_fold_is_effective():
    def acc_step(scale, x, acc):
        acc.g.add_(x @ x.T * scale)
        acc.m.add_(x.sum(1))
        return acc

    acc = daef.rolann.RolannStats(g=torch.zeros(4, 4), m=torch.zeros(4))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32))
    rep = donation.probe(acc_step, 2.0, x, acc, donate_argnums=(2,))
    assert (rep.requested, rep.effective_params, rep.kinds) == ((2,), (2,), ("in-place",))
    assert rep.ok is True and rep.dropped == () and rep.fn_name == "acc_step"
    assert rep.backend == "cpu" and "effective (1/1" in rep.describe()
    assert torch.equal(acc.g, 2.0 * x @ x.T)  # the call ran for real


def test_probe_storage_reused_by_an_output():
    rep = donation.probe(lambda t: t.view(-1), torch.ones(2, 3), donate_argnums=(0,))
    assert rep.ok is True and rep.kinds == ("storage-reused",)


def test_probe_allocating_function_is_dropped():
    def step(acc, x):
        return acc + x

    rep = donation.probe(step, torch.zeros(16, 16), torch.ones(16, 16), donate_argnums=(0,))
    assert rep.requested == (0,) and rep.effective_params == () and rep.dropped == (0,)
    assert rep.ok is False and "NOT effective (inputs (0,)" in rep.describe()


def test_probe_no_donation_requested():
    rep = donation.probe(lambda x: x * 2, torch.ones(4))
    assert rep.requested == () and rep.effective_params is None and rep.ok is None
    assert "unknown" in rep.describe()


def test_probe_rejects_an_argument_without_tensors():
    with pytest.raises(TypeError, match="argument 0, which holds no tensor"):
        donation.probe(lambda cfg, x: x, 7, torch.ones(3), donate_argnums=(0,))


def test_fleet_server_probe_is_a_donation_report():
    from repro_torch.serving import server

    from repro_torch.analysis.__main__ import donation_reports

    assert server.DonationReport is donation.DonationReport
    rep = donation_reports("cpu")[0]
    assert isinstance(rep, donation.DonationReport) and rep.ok is None
    assert rep.requested == (2,) and rep.fn_name == "_score_tile"


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

def _function_lines(path: Path) -> set[int]:
    lines = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lines.update(range(node.lineno, node.end_lineno + 1))
    return lines


@pytest.mark.parametrize("name", CARRIED)
def test_carried_rules_agree_with_the_reference(name):
    """Same (line, rule) findings as the reference's linter; for RPR002 the
    import-time half (the jit half's findings lie in jit functions)."""
    path = REF_FIXTURES / f"{name}.py"
    ref = jlint.check_path(path)
    if name == "rpr002_env":
        inside = _function_lines(path)
        ref = [f for f in ref if f.line not in inside]
    got = lint.check_path(path)
    assert got and _pairs(got) == _pairs(ref)


@pytest.mark.parametrize("name", ["rpr003_hostnp", "rpr004_traceflow", "rpr008_interpret"])
def test_jit_and_pallas_rules_are_not_carried(name):
    """RPR003/RPR004 there are jit bodies (no capture), RPR008 is Pallas."""
    assert jlint.check_path(REF_FIXTURES / f"{name}.py")
    assert lint.check_path(REF_FIXTURES / f"{name}.py") == []


@pytest.mark.parametrize("fixture", sorted(FIXTURES.glob("rpr*.py")), ids=lambda p: p.stem)
def test_fixture_findings_exact(fixture):
    got = _pairs(lint.check_path(fixture))
    assert got == expected_findings(fixture) and got, (
        f"{fixture.name}: findings != markers\n"
        + "\n".join(f.format() for f in lint.check_path(fixture)))


@pytest.mark.parametrize("fixture", sorted(FIXTURES.glob("rpr*.py")), ids=lambda p: p.stem)
def test_port_fixtures_are_clean_under_the_reference(fixture):
    """The reference's repo-wide lint walks tests/ and does not skip this
    directory: its fixtures hold only what the port's rules alone flag."""
    assert jlint.check_path(fixture) == []


def test_disable_comment_suppresses_only_that_line():
    src = (
        "import torch\n"
        "def f(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        a = x.item()  # repro-lint: disable=RPR003\n"
        "        b = x.item()\n"
        "        c = x.item()  # repro-lint: disable=RPR002, RPR004\n"
    )
    assert [(f.line, f.rule) for f in lint.check_source(src)] == [(5, "RPR003"), (6, "RPR003")]


def test_library_and_privacy_scope_by_marker_and_path():
    src = "import time\nimport os\nT = os.environ.get('X')\ndef f():\n    return time.time()\n"
    assert lint.check_source(src, "tests/x.py") == []
    for path in ("src/repro_torch/core/x.py", "src/repro_torch/analysis/x.py"):
        assert _pairs(lint.check_source(src, path)) == Counter({(3, "RPR002"): 1, (5, "RPR006"): 1})
    assert lint.check_source(src, "src/repro_torch/launch/x.py") == []
    assert lint.check_source("# repro-lint: library\n" + src, "x.py")
    assert lint.check_source(src, "src/repro/core/x.py") == []   # the reference's tree
    seed = "import torch\ntorch.manual_seed(0)\n"
    assert lint.check_source(seed, "src/repro_torch/core/x.py") == []
    assert _pairs(lint.check_source(seed, "src/repro_torch/privacy/x.py")) == \
        Counter({(2, "RPR007"): 1})


def test_capture_taint_skips_static_metadata_and_attributes():
    src = (
        "import torch\n"
        "class G:\n"
        "    def capture(self, x):\n"
        "        with torch.cuda.graph(self.graph):\n"
        "            if self.flag and x.size(0) > 1 and x.numel() and x.device.type:\n"
        "                self.out = x * int(x.shape[0])\n"
        "            y = torch.zeros(3)\n"
        "            if y.any():\n"
        "                pass\n"
    )
    assert [(f.line, f.rule) for f in lint.check_source(src)] == [(8, "RPR004")]


def test_port_lints_clean_without_a_baseline():
    assert lint.main([str(REPO / "src" / "repro_torch"), str(REPO / "chip_smoke.py"),
                      "--no-baseline"]) == 0


def test_syntax_error_reported_not_raised():
    (f,) = lint.check_source("def broken(:\n", "bad.py")
    assert f.rule == "RPR000" and "syntax error" in f.message


def test_baseline_round_trip(tmp_path):
    findings = lint.check_path(FIXTURES / "rpr003_capture_sync.py")
    base = tmp_path / "repro-lint.baseline"
    lint.write_baseline(findings, base)
    key = (str((FIXTURES / "rpr003_capture_sync.py").as_posix()), "RPR003")
    assert lint.load_baseline(base) == Counter({key: 6})
    kept, stale = lint.apply_baseline(findings, lint.load_baseline(base))
    assert kept == [] and not stale
    kept, stale = lint.apply_baseline(findings[:4], Counter({key: 6}))
    assert kept == [] and stale == Counter({key: 2})
    kept, _ = lint.apply_baseline(findings, Counter({key: 5}))
    assert kept == findings[5:]
    (tmp_path / "bad").write_text("only two\n")
    with pytest.raises(SystemExit, match="bad baseline line"):
        lint.load_baseline(tmp_path / "bad")


def test_cli_exit_codes_and_output(tmp_path):
    def run(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                              capture_output=True, text=True, cwd=REPO, env=ENV)

    # directory walks skip the fixture directories...
    proc = run("--no-baseline", str(FIXTURES), str(REF_FIXTURES))
    assert proc.returncode == 0 and "clean (0 files)" in proc.stdout, proc.stdout + proc.stderr
    # ...explicit files always lint, with or without the `lint` word
    for args in (("--no-baseline",), ("lint", "--no-baseline")):
        proc = run(*args, str(FIXTURES / "rpr004_capture_flow.py"))
        assert proc.returncode == 1 and "RPR004" in proc.stdout and "hint:" in proc.stdout
    base = tmp_path / "b.baseline"
    assert run("--write-baseline", str(base), str(FIXTURES / "rpr004_capture_flow.py")
               ).returncode == 0
    proc = run("--baseline", str(base), str(FIXTURES / "rpr004_capture_flow.py"))
    assert proc.returncode == 0, proc.stdout
    assert run("--baseline", str(tmp_path / "missing"), str(FIXTURES)).returncode != 0


# ---------------------------------------------------------------------------
# the CLI's runtime self-checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", ["retrace", "donation"])
def test_selfcheck_cli_exits_zero_on_the_cpu(check):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", check, "--device", "cpu"],
                          capture_output=True, text=True, cwd=REPO, env=ENV, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{check} self-check:" in proc.stdout


def _reference_serve():
    """The reference's ``_retrace_selfcheck`` serve, with its results."""
    from repro.core import daef as jdaef
    from repro.engine import DAEFEngine, ExecutionPlan
    from repro.serving import server as jserver

    cfg = jdaef.DAEFConfig(layer_sizes=(6, 3, 6), lam_hidden=0.9, lam_last=0.9)
    engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=4))
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4, 6, 48)).astype(np.float32)
    fl = engine.fit(xs, seeds=jnp.arange(4))
    srv = jserver.FleetServer(engine, fl, tile_width=8, use_cache=False)
    n_shapes = srv.warmup()
    for rid, (tenant, n) in enumerate(RAGGED_REQUESTS):
        srv.submit(tenant, rng.normal(size=(6, n)).astype(np.float32), request_id=rid)
    srv.flush()
    return n_shapes, srv.thresholds, {rid: srv.take(rid) for rid in range(len(RAGGED_REQUESTS))}


def test_retrace_selfcheck_serves_the_references_scores():
    out = retrace_serve("cpu")
    n_shapes, mus, ref = _reference_serve()
    assert out["shapes"] == n_shapes
    assert (out["serve"].traces, out["serve"].compiles) == (0, 0)
    for rid, (tenant, n) in enumerate(RAGGED_REQUESTS):
        got, want = out["results"][rid], ref[rid]
        assert got.tenant == want.tenant == tenant and got.scores.shape == (n,)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-5, rtol=1e-5)
        off_ties = np.abs(np.asarray(want.scores) - float(mus[tenant])) > 1e-5
        assert np.array_equal(got.flags[off_ties], np.asarray(want.flags)[off_ties])
