"""The port's mesh paths over four gloo ranks on the CPU, against the
reference's same calls on four forced host devices.

One launch each, per test module: four rank processes
(tests/_torch_mesh_ranks.py, one interpreter each, ``OMP_NUM_THREADS=1``,
a gloo group from a ``FileStore`` under ``tmp_path``, no TCP port) and
the reference through ``tests/_mesh_harness.run_on_devices`` with
``n_devices=4`` in two processes (the fleet cases, the data mesh), all
side by side; each writes an ``.npz``.  Every launch
has its own timeout, and nothing of ``torch.distributed`` runs in the
pytest process.

Cases (tests/_torch_mesh_cases.py): the tenant-sharded fit, scores and
thresholds of K = 8 tenants, 2 a rank; ``fleet_merge_tree`` with groups of
2 (inside a rank) and of 8 (two cross rounds of the butterfly), both
methods; ``merge_state_tree`` over 8 masked slots; the data-sharded fit,
both methods, on a ("data",) mesh of 4 and a ("pod", "data") 2 × 2 mesh.
Held at TOLS through ``assert_models_match`` (tests/_torch_parity.py);
each tenant and site draws its own mixture, so the fleets' last layers are
held at the larger of the κ bar and ``cancellation_bar``; the results
every rank holds alike are the same bits on every rank.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _mesh_harness import ROOT, run_on_devices
from _torch_parity import assert_close, assert_models_match, assert_sum_close

import _torch_mesh_cases as cases
from repro_torch.core import daef as tdaef
from repro_torch.core import fleet as tfleet
from repro_torch.core import rolann as trol
from repro_torch.engine import DAEFEngine, ExecutionPlan
from repro_torch.train import checkpoint

TESTS = os.path.join(ROOT, "tests")
RANK_TIMEOUT_S = 240
REF_TIMEOUT_S = 300

_REFERENCE_PRELUDE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_mesh_cases as cases
from repro.core import daef, fleet_sharded
from repro.engine import DAEFEngine, ExecutionPlan

out = {{}}


def put(prefix, tree):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{{prefix}}/leaf{{i}}"] = np.asarray(leaf)
"""

_REFERENCE_FLEET = """
cfg = daef.DAEFConfig(**cases.KW)
xs, seeds, n_valid = cases.tenant_data()
engine = DAEFEngine(cfg, ExecutionPlan(mode="mesh", tenants=cases.K, mesh_devices=cases.D))
fl = engine.fit(xs, seeds=seeds)
put("fit", fl)
out["fit/scores"] = np.asarray(engine.scores(fl, xs, n_valid=n_valid))
out["fit/thr"] = np.asarray(engine.thresholds(fl))

sites = cases.site_data()
for method in cases.METHODS:
    mcfg = daef.DAEFConfig(**dict(cases.KW, method=method))
    tree = DAEFEngine(mcfg, ExecutionPlan(mode="mesh", tenants=cases.K, mesh_devices=cases.D,
                                          merge="tree"))
    sfl = tree.fit(sites, seeds=np.ones(cases.K, np.int32))
    for group in cases.TREE_GROUPS:
        put(f"tree/{{method}}/{{group}}", tree.reduce(sfl, group))
    if method == "gram":
        m = sfl.model
        put("state", fleet_sharded.merge_state_tree(
            mcfg, m.encoder_factors, m.layer_knowledge, cases.STATE_MASK,
            mesh=fleet_sharded.tenant_mesh(cases.D)))
"""

_REFERENCE_DATA = """
x = jnp.asarray(cases.mesh_data())
for name, (shape, axes) in cases.DATA_MESHES.items():
    mesh = compat.make_mesh(shape, axes)
    for method in cases.METHODS:
        dcfg = daef.DAEFConfig(**dict(cases.KW, method=method))
        eng = DAEFEngine(dcfg, ExecutionPlan(mode="mesh", mesh_axes=axes), mesh=mesh)
        model = jax.jit(eng.fit)(x)   # the eager shard_map compiles op by op
        put(f"data/{{name}}/{{method}}", model)
        out[f"data/{{name}}/{{method}}/scores"] = np.asarray(eng.scores(model, x))
        out[f"data/{{name}}/{{method}}/thr"] = np.asarray(eng.thresholds(model))
"""

_REFERENCE_END = """
np.savez({path!r}, **out)
print("REFERENCE OK")
"""


def _reference(body: str, path) -> None:
    script = (_REFERENCE_PRELUDE + body + _REFERENCE_END).format(tests=TESTS, path=str(path))
    assert "REFERENCE OK" in run_on_devices(script, n_devices=cases.D, timeout=REF_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four port ranks, run the reference beside them, and load
    every ``.npz``: (the reference's arrays, each rank's arrays)."""
    out = tmp_path_factory.mktemp("mesh_runs")
    store = out / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    ranks = [
        subprocess.Popen([sys.executable, os.path.join(TESTS, "_torch_mesh_ranks.py"),
                          str(r), str(cases.D), str(store), str(out)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(cases.D)
    ]
    try:
        with ThreadPoolExecutor(2) as pool:
            for job in [pool.submit(_reference, body, out / f"ref_{name}.npz")
                        for name, body in (("fleet", _REFERENCE_FLEET),
                                           ("data", _REFERENCE_DATA))]:
                job.result()
        for r, proc in enumerate(ranks):
            _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = dict(np.load(out / "ref_fleet.npz")) | dict(np.load(out / "ref_data.npz"))
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(cases.D)]
    return ref, got


def _leaves(arrays: dict, prefix: str) -> list:
    n = sum(1 for key in arrays if key.startswith(prefix + "/leaf"))
    return [torch.from_numpy(arrays[f"{prefix}/leaf{i}"]) for i in range(n)]


def _state(arrays: dict, prefix: str, method: str, fleet: bool):
    """Rebuild a fleet (or a model) from its leaves on the port's
    engine's structure."""
    cfg = tdaef.DAEFConfig(**dict(cases.KW, method=method))
    template = DAEFEngine(cfg, ExecutionPlan(), device="cpu")._template()
    if fleet:
        z = np.zeros((0,), np.float32)
        template = tfleet.DAEFFleet(model=template, seeds=z, lam_hidden=z, lam_last=z)
    return checkpoint.unflatten(template, _leaves(arrays, prefix))


def _as_gram(model):
    if hasattr(model.layer_knowledge[0], "u"):
        return model._replace(layer_knowledge=tuple(
            trol.factors_to_stats(k) for k in model.layer_knowledge))
    return model


def _match_fleets(ref_fl, got_fl):
    assert got_fl.size == ref_fl.size
    assert torch.equal(got_fl.seeds, ref_fl.seeds)
    for i in range(got_fl.size):
        jm = _as_gram(checkpoint.map_leaves(lambda a, i=i: a[i], ref_fl.model))
        tm = _as_gram(checkpoint.map_leaves(lambda a, i=i: a[i], got_fl.model))
        assert_models_match(jm, tm, cases.KW["lam_last"], m_cancels=True)


def _same_on_every_rank(got: list, prefix: str) -> None:
    keys = [k for k in got[0] if k.startswith(prefix)]
    assert keys
    for g in got[1:]:
        for key in keys:
            assert np.array_equal(g[key], got[0][key], equal_nan=True), key


def test_tenant_sharded_fit_scores_and_thresholds(runs):
    ref, got = runs
    _same_on_every_rank(got, "fit")
    _match_fleets(_state(ref, "fit", "gram", True), _state(got[0], "fit", "gram", True))
    _, _, n_valid = cases.tenant_data()
    scores = got[0]["fit/scores"]
    for t in range(cases.K):
        assert np.isnan(scores[t, n_valid[t]:]).all() and np.isfinite(scores[t, :n_valid[t]]).all()
    assert_close(np.nan_to_num(scores, nan=-1.0), np.nan_to_num(ref["fit/scores"], nan=-1.0))
    assert_close(got[0]["fit/thr"], ref["fit/thr"])


@pytest.mark.parametrize("group", cases.TREE_GROUPS, ids=["inside a rank", "over all ranks"])
@pytest.mark.parametrize("method", cases.METHODS)
def test_fleet_merge_tree(runs, method, group):
    ref, got = runs
    prefix = f"tree/{method}/{group}"
    _same_on_every_rank(got, prefix)
    got_fl = _state(got[0], prefix, method, True)
    assert got_fl.size == cases.K // group
    _match_fleets(_state(ref, prefix, method, True), got_fl)


def test_merge_state_tree(runs):
    """The merged encoder by its S (TOLS) and U S² Uᵀ, the knowledge's
    (G, M) by ``assert_sum_close``, as ``assert_models_match`` holds them."""
    ref, got = runs
    _same_on_every_rank(got, "state")
    (tu, ts, *tknw), (ju, js, *jknw) = _leaves(got[0], "state"), _leaves(ref, "state")
    assert_close(ts, js, what="encoder S")
    assert_sum_close((tu * ts**2) @ tu.T, (ju * js**2) @ ju.T, what="encoder U S^2 U^T")
    for t, j in zip(tknw, jknw, strict=True):
        assert_sum_close(t, j, what="knowledge")


@pytest.mark.parametrize("method", cases.METHODS)
@pytest.mark.parametrize("mesh", sorted(cases.DATA_MESHES))
def test_data_sharded_fit(runs, mesh, method):
    ref, got = runs
    prefix = f"data/{mesh}/{method}"
    _same_on_every_rank(got, prefix)   # weights alike; errors and scores gathered
    assert_models_match(_as_gram(_state(ref, prefix, method, False)),
                        _as_gram(_state(got[0], prefix, method, False)), cases.KW["lam_last"])
    assert_close(got[0][prefix + "/scores"], ref[prefix + "/scores"])
    assert_close(got[0][prefix + "/thr"], ref[prefix + "/thr"])


def test_the_pytest_process_starts_no_process_group(runs):
    assert not (torch.distributed.is_available() and torch.distributed.is_initialized())
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        assert var not in os.environ
