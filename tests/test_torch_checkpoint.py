"""repro_torch.train.checkpoint (and its msgpack codec) against
repro.train.checkpoint: the same bytes on disk, the same leaf order, and
checkpoints that cross between the packages both ways.

* The codec (``repro_torch.train._msgpack``) writes exactly the bytes of
  ``msgpack.packb`` for every object a manifest holds (the smallest int
  encodings at each boundary, float64 floats, str, nested maps and arrays)
  and reads them back.
* ``checkpoint.flatten`` gives ``jax.tree.flatten``'s leaves in its order:
  models of both methods, fleets, a session's tree (dict keys sorted), and
  ``None`` / ``()`` as empty nodes.
* A model, a fleet and a mid-federation session directory saved by either
  package load in the other and score the same (TOLS), for both methods;
  the port's ``data.bin`` of a model is byte-identical to the reference's,
  and its manifest differs only in the informational ``"treedef"``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, lowrank_data

from repro.core import daef as jdaef
from repro.core import fleet as jfleet
from repro.engine import DAEFEngine as JEngine
from repro.engine import ExecutionPlan as JPlan
from repro.train import checkpoint as jck
from repro_torch import interop
from repro_torch.core import daef as tdaef
from repro_torch.core import fleet as tfleet
from repro_torch.engine import DAEFEngine, ExecutionPlan
from repro_torch.train import _msgpack
from repro_torch.train import checkpoint as tck

M0, LATENT, N, K = 9, 3, 120, 4
LAYERS = (M0, LATENT, 5, 7, M0)
LAM_LAST = 0.9


def _kw(method="gram"):
    return dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=LAM_LAST, method=method,
                stats_backend="einsum")


def _tcfg(method="gram"):
    return tdaef.DAEFConfig(**_kw(method))


def _jcfg(method="gram"):
    return jdaef.DAEFConfig(**_kw(method))


@functools.lru_cache(maxsize=None)
def _x(n=N, seed=0):
    x = lowrank_data(M0, LATENT, n, seed)
    x.flags.writeable = False
    return x


@functools.lru_cache(maxsize=None)
def _xs(seed=1):
    xs = np.stack([lowrank_data(M0, LATENT, N, seed + t) for t in range(K)])
    xs.flags.writeable = False
    return xs


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

INT_BOUNDARIES = [0, 1, 127, 128, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32, 2**63,
                  2**64 - 1, -1, -32, -33, -128, -129, -32_768, -32_769, -(2**31),
                  -(2**31) - 1, -(2**63)]
OBJECTS = {
    "ints": INT_BOUNDARIES,
    "floats": [0.0, -0.0, 1.5, -2.25e-300, 3.4e38, float("inf"), float("-inf"), 1e-5],
    "bools and nil": [True, False, None, [None, True], {"a": False}],
    "str lengths": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65_535, "f" * 65_536,
                    "ü ∑ 中文"],
    "array lengths": [list(range(15)), list(range(16)), list(range(65_535)),
                      list(range(65_536)), (1, 2, 3), []],
    "map sizes": [{f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
                  {f"k{i}": i for i in range(65_536)}, {}],
    "manifest": {"treedef": "PyTreeDef(*)", "leaves": [
        {"__array__": 0, "dtype": "float32", "shape": [29, 15]},
        {"__scalar__": 1.5, "dtype": "float64"}, {"__scalar__": -7, "dtype": "int32"},
        {"__scalar__": True, "dtype": "bool"}], "offsets": [0, 1_740], "total_bytes": 1_740},
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_codec_writes_msgpacks_bytes_and_reads_them(name):
    obj = OBJECTS[name]
    want = msgpack.packb(obj)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("value", INT_BOUNDARIES)
def test_codec_int_boundaries_one_by_one(value):
    assert _msgpack.packb(value) == msgpack.packb(value)
    assert _msgpack.unpackb(msgpack.packb(value)) == value


def test_codec_reads_what_the_reference_writes():
    """Every manifest the reference wrote here (a model of each method and a
    fleet) reads back as msgpack reads it, and packs to the same bytes."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for i, tree in enumerate((_jfit("gram"), _jfit("svd"), _jfleet())):
            path = jck.save(os.path.join(d, str(i)), tree)
            with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
                raw = f.read()
            obj = _msgpack.unpackb(raw)
            assert obj == msgpack.unpackb(raw)
            assert _msgpack.packb(obj) == raw


def test_codec_refuses_what_is_outside_the_subset():
    with pytest.raises(_msgpack.MsgpackError, match="cannot serialize"):
        _msgpack.packb({"a": object()})
    with pytest.raises(_msgpack.MsgpackError, match="64 bits"):
        _msgpack.packb(2**64)
    with pytest.raises(_msgpack.MsgpackError, match="64 bits"):
        _msgpack.packb(-(2**63) - 1)
    with pytest.raises(_msgpack.MsgpackError, match="trailing"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(_msgpack.MsgpackError, match="truncated"):
        _msgpack.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(_msgpack.MsgpackError, match="outside"):
        _msgpack.unpackb(b"\xc7\x01\x00\x00")  # ext8


# ---------------------------------------------------------------------------
# leaf order: checkpoint.flatten == jax.tree.flatten
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jfit(method):
    return jdaef.fit(_jcfg(method), jnp.asarray(_x()))


@functools.lru_cache(maxsize=None)
def _jfleet(method="gram"):
    return jfleet._fit_fleet(_jcfg(method), jnp.asarray(_xs()),
                             seeds=jnp.arange(K, dtype=jnp.int32))


def _jleaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.flatten(tree)[0]]


def _assert_same_leaves(port_leaves, ref_leaves):
    assert len(port_leaves) == len(ref_leaves)
    for i, (a, b) in enumerate(zip(port_leaves, ref_leaves, strict=True)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_flatten_order_of_models_and_fleets(method):
    jm, jf = _jfit(method), _jfleet(method)
    tm = interop.model_from_numpy(_tcfg(method), _jleaves(jm), device="cpu")
    tf = interop.fleet_from_numpy(_tcfg(method), _jleaves(jf), device="cpu")
    _assert_same_leaves(tck.flatten(tm), _jleaves(jm))
    _assert_same_leaves(tck.flatten(tf), _jleaves(jf))
    assert tf.seeds.dtype == torch.int32


def test_flatten_order_of_a_session_tree():
    """A session's tree: {"model", "sites"} in sorted key order, each site
    (SvdFactors, knowledge, host error pool); an absent model is ()."""
    jm = _jfit("gram")
    tm = interop.model_from_numpy(_tcfg(), _jleaves(jm), device="cpu")
    jstate = (jm.encoder_factors, jm.layer_knowledge, np.asarray(jm.train_errors))
    tstate = interop.exchange_state_from_numpy(_tcfg(), _jleaves(jstate), device="cpu")
    for jmodel, tmodel in ((jm, tm), ((), ())):
        jtree = {"sites": [jstate, jstate], "model": jmodel}
        ttree = {"sites": [tstate, tstate], "model": tmodel}
        _assert_same_leaves(tck.flatten(ttree), _jleaves(jtree))


def test_flatten_of_plain_trees_and_empty_nodes():
    a, b, c, d = (np.full(i + 1, i, np.float32) for i in range(4))
    tree = {"z": [a, None, (), {"y": b, "x": c}], "b": (d, [], {}), "a": None}
    _assert_same_leaves(tck.flatten(tree), _jleaves(tree))
    rebuilt = tck.unflatten(tree, [x * 2 for x in tck.flatten(tree)])
    assert rebuilt["a"] is None and rebuilt["z"][2] == () and rebuilt["b"][1:] == ([], {})
    np.testing.assert_array_equal(rebuilt["z"][3]["x"], c * 2)
    assert tck.describe(tree).startswith("{'a': None, 'b': (*, [], {}), 'z': [*, None, ()")


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _engines(method, tenants):
    plan = dict(mode="vmap", tenants=tenants)
    return (JEngine(_jcfg(method), JPlan(**plan)),
            DAEFEngine(_tcfg(method), ExecutionPlan(**plan), device="cpu"))


@pytest.mark.parametrize("method", ["gram", "svd"])
@pytest.mark.parametrize("kind", ["model", "fleet"])
def test_reference_checkpoint_loads_in_the_port(method, kind, tmp_path):
    je, te = _engines(method, 1 if kind == "model" else K)
    state = _jfit(method) if kind == "model" else _jfleet(method)
    path = je.save(state, str(tmp_path / kind))
    loaded = te.load(path)
    assert isinstance(loaded, tdaef.DAEFModel if kind == "model" else tfleet.DAEFFleet)
    _assert_same_leaves(tck.flatten(loaded), _jleaves(state))
    assert all(leaf.device.type == "cpu" for leaf in tck.flatten(loaded))
    x = _x(n=60, seed=9) if kind == "model" else _xs(seed=20)[..., :60]
    assert_close(te.scores(loaded, x), je.scores(state, jnp.asarray(x)))


@pytest.mark.parametrize("method", ["gram", "svd"])
@pytest.mark.parametrize("kind", ["model", "fleet"])
def test_port_checkpoint_loads_in_the_reference(method, kind, tmp_path):
    je, te = _engines(method, 1 if kind == "model" else K)
    x = _x() if kind == "model" else _xs()
    state = (te.fit(x) if kind == "model"
             else te.fit(x, seeds=np.arange(K, dtype=np.int32)))
    path = te.save(state, str(tmp_path / kind))
    loaded = je.load(path)
    _assert_same_leaves(tck.flatten(state), _jleaves(loaded))
    xt = _x(n=60, seed=9) if kind == "model" else _xs(seed=20)[..., :60]
    assert_close(je.scores(loaded, jnp.asarray(xt)), te.scores(state, xt))


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_same_bytes_on_disk(method, tmp_path):
    """The same model saved by both packages: data.bin byte for byte, the
    manifest equal but for the informational treedef."""
    jm = _jfit(method)
    tm = interop.model_from_numpy(_tcfg(method), _jleaves(jm), device="cpu")
    jp, tp = jck.save(str(tmp_path / "j"), jm), tck.save(str(tmp_path / "t"), tm)
    for name in ("data.bin",):
        with open(os.path.join(jp, name), "rb") as a, open(os.path.join(tp, name), "rb") as b:
            assert a.read() == b.read()
    with open(os.path.join(jp, "manifest.msgpack"), "rb") as f:
        jman = msgpack.unpackb(f.read())
    with open(os.path.join(tp, "manifest.msgpack"), "rb") as f:
        tman = msgpack.unpackb(f.read())
    assert jman.pop("treedef").startswith("PyTreeDef")
    assert tman.pop("treedef").startswith("DAEFModel(")
    assert jman == tman


def _session_parts(rounds=3, sites=3, seed=30):
    return [[lowrank_data(M0, LATENT, 60, seed + 10 * r + s) for s in range(sites)]
            for r in range(rounds)]


@pytest.mark.parametrize("direction", ["reference to port", "port to reference"])
def test_mid_federation_session_crosses(direction, tmp_path):
    """An async session saved after two rounds (site "c" stale) restores in
    the other package and runs round 3 as the saver does."""
    plan = dict(federation="async", merge="pairwise", max_staleness=1)
    je = JEngine(_jcfg(), JPlan(**plan))
    te = DAEFEngine(_tcfg(), ExecutionPlan(**plan), device="cpu")
    (a0, b0, c0), (a1, b1, _), (a2, _, c2) = _session_parts()
    r1, r2, r3 = {"a": a0, "b": b0, "c": c0}, {"a": a1, "b": b1}, {"a": a2, "c": c2}

    def run(session, rounds, lib):
        for r in rounds:
            model = session.round({k: lib(v) for k, v in r.items()})
        return model

    ident = np.asarray
    if direction == "reference to port":
        saver, loader, slib, llib = je, te, jnp.asarray, ident
    else:
        saver, loader, slib, llib = te, je, ident, jnp.asarray
    s = saver.session()
    run(s, [r1, r2], slib)
    path = saver.save(s, str(tmp_path / "session"))
    assert os.path.isfile(os.path.join(path, "session.json"))
    restored = loader.load(path)
    assert restored.clock == 2 and restored.rounds_run == 2
    assert restored.sites == {"a": 0, "b": 0, "c": 1}
    assert restored._ledger["a"].submits == 2
    got, want = run(restored, [r3], llib), run(s, [r3], slib)
    jm, tm = (want, got) if direction == "reference to port" else (got, want)
    assert_models_match(jm, tm, LAM_LAST)


def test_sync_session_and_empty_model_cross(tmp_path):
    """A sync session's model crosses; a session saved before any round
    (no model, an empty data.bin) restores in the port with none (the
    reference's memmap cannot map an empty file)."""
    je = JEngine(_jcfg(), JPlan(merge="pairwise"))
    te = DAEFEngine(_tcfg(), ExecutionPlan(merge="pairwise"), device="cpu")
    parts = _session_parts(rounds=1)[0]
    s = te.session()
    te.save(s, str(tmp_path / "empty"))
    empty = te.load(str(tmp_path / "empty"))
    assert empty.model is None and empty.rounds_run == 0
    s.round(parts)
    te.save(s, str(tmp_path / "one"))
    back = je.load(str(tmp_path / "one"))
    _assert_same_leaves(tck.flatten(s.model), _jleaves(back.model))
    assert te.load(str(tmp_path / "one")).rounds_run == 1


# ---------------------------------------------------------------------------
# errors and odds
# ---------------------------------------------------------------------------

def test_leaf_count_mismatch_raises_as_the_reference(tmp_path):
    tm = interop.model_from_numpy(_tcfg(), _jleaves(_jfit("gram")), device="cpu")
    path = tck.save(str(tmp_path / "m"), tm)
    small = tdaef.DAEFConfig(layer_sizes=(M0, LATENT, M0))
    with pytest.raises(ValueError) as terr:
        tck.restore(path, DAEFEngine(small, device="cpu")._template())
    with pytest.raises(ValueError) as jerr:
        jck.restore(path, JEngine(jdaef.DAEFConfig(layer_sizes=(M0, LATENT, M0)))._template())
    assert str(terr.value) == str(jerr.value)
    from repro_torch.engine import PlanError

    with pytest.raises(PlanError, match="does not match"):
        DAEFEngine(small, device="cpu").load(path)


def test_bfloat16_leaf_is_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        tck.save(str(tmp_path / "bf16"), {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert not os.path.exists(str(tmp_path / "bf16.tmp"))


def test_scalars_steps_and_atomic_rename(tmp_path):
    tree = {"step": np.int32(7), "lr": 0.5, "flag": np.bool_(True),
            "w": torch.arange(6, dtype=torch.float64).reshape(2, 3)}
    assert tck.latest_step(str(tmp_path)) is None
    for step in (3, 12, 5):
        out = tck.save(str(tmp_path), tree, step=step)
        assert out.endswith(f"step_{step}") and not os.path.exists(out + ".tmp")
    assert tck.latest_step(str(tmp_path)) == 12 == jck.latest_step(str(tmp_path))
    port, ref = tck.restore(out, tree), jck.restore(out, tree)
    for key in tree:
        assert port[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(port[key], ref[key])
    assert port["step"] == 7 and port["w"].dtype == np.float64


def test_engine_load_places_leaves_on_its_device(tmp_path):
    te = DAEFEngine(_tcfg(), ExecutionPlan(mode="vmap", tenants=K), device="cpu")
    fl = te.fit(_xs())
    back = te.load(te.save(fl, str(tmp_path / "f")))
    for a, b in zip(tck.flatten(back), tck.flatten(fl), strict=True):
        assert isinstance(a, torch.Tensor) and a.device == te.device
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_interop_exchange_state_both_ways():
    jm = _jfit("svd")
    jstate = (jm.encoder_factors, jm.layer_knowledge, np.asarray(jm.train_errors))
    tstate = interop.exchange_state_from_numpy(_tcfg("svd"), _jleaves(jstate), device="cpu")
    assert isinstance(tstate[2], np.ndarray)
    _assert_same_leaves(interop.exchange_state_to_numpy(tstate), _jleaves(jstate))
    with pytest.raises(ValueError, match="expected"):
        interop.exchange_state_from_numpy(_tcfg("gram"), _jleaves(jstate), device="cpu")


def test_no_msgpack_import_in_the_port():
    """The card's machine has no msgpack: the port never imports it, even
    where it is installed (the codec stands in)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "msgpack" for n in names), path
