"""Rules the port keeps: what it may import, and where it runs by default."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)

from repro_torch import device as tdevice
from repro_torch import interop
from repro_torch.core import activations, anomaly, daef, rolann
from repro_torch.kernels import KERNELS, _build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            roots.update(a.value.split(".")[0] for a in node.args
                         if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert path.is_file()
    bad = _imported_roots(path).intersection(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_check_sees_forbidden_imports(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import daef\n"
                 "import importlib\nimportlib.import_module('jaxlib.xla')\n")
    assert _imported_roots(f) >= {"jax", "repro", "jaxlib"}


LIBRARY_KERNELS = ("scaled_dot_product_attention", "torch.compile", "flash_attn")
LIBRARY_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _library_kernels(path: Path) -> set[str]:
    """Finished kernels a source names: fused attention, the compiler, a
    flash-attention package (chip_smoke.py may time SDPA as a yardstick)."""
    text = path.read_text()
    return {name for name in LIBRARY_KERNELS if name in text}


@pytest.mark.parametrize("path", LIBRARY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_kernel(path):
    assert not _library_kernels(path), f"{path.relative_to(ROOT)} names {_library_kernels(path)}"


def test_library_kernel_check_sees_them(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("import torch.nn.functional as F\nF.scaled_dot_product_attention(q, k, v)\n"
                 "fast = torch.compile(fn)\nfrom flash_attn import flash_attn_func\n")
    assert _library_kernels(f) == set(LIBRARY_KERNELS)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card|none is present"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    t = tdevice.as_tensor(np.zeros(3), torch.device("cpu"))
    assert t.dtype == tdevice.DEFAULT_DTYPE == torch.float32
    assert tdevice.as_tensor(torch.zeros(3, dtype=torch.float64), t.device).dtype == torch.float64


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    cfg = daef.DAEFConfig(layer_sizes=(4, 2, 4))
    x = np.random.default_rng(0).normal(size=(4, 50)).astype(np.float32)
    model = daef.fit(cfg, x, device="cpu")
    errs = model.train_errors
    _no_card(monkeypatch)
    calls = [
        lambda: daef.fit(cfg, x),
        lambda: daef.fit_chunked(cfg, x, chunk_samples=16),
        lambda: daef.fit_stream(cfg, [x[:, :25], x[:, 25:]]),
        lambda: rolann.init_stats(2, 4, activations.logsig),
        lambda: daef.predict(cfg, model, x),
        lambda: daef.reconstruction_error(cfg, model, x),
        lambda: anomaly.threshold(errs),
        lambda: anomaly.classify(errs, 0.5),
        lambda: anomaly.binary_metrics([0, 1], [0, 1]),
        lambda: anomaly.evaluate(errs, errs, np.zeros(50)),
        lambda: interop.model_from_numpy(cfg, interop.model_to_numpy(model)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="none is present"):
            call()


def test_model_on_another_device_is_not_moved_silently():
    cfg = daef.DAEFConfig(layer_sizes=(4, 2, 4))
    model = daef.fit(cfg, np.ones((4, 20), np.float32), device="cpu")
    meta = model._replace(weights=tuple(w.to("meta") for w in model.weights))
    with pytest.raises(ValueError, match="model lies on meta"):
        daef.predict(cfg, meta, np.ones((4, 5), np.float32), device="cpu")


def test_every_kernel_library_has_its_source():
    """Each library _build knows compiles one source in the repo; its file
    name hashes that source and the headers it includes, so two libraries
    never share a name.  Nothing is built here."""
    paths = {name: _build.library_path(name) for name in KERNELS}
    for name, path in paths.items():
        assert _build.source(name).is_file() and _build.source(name).suffix == ".cu"
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert len(set(paths.values())) == len(paths)


def test_library_path_follows_includes_into_other_kernels(tmp_path, monkeypatch):
    """An edit to a header that a source includes from another kernel's
    directory, directly or through a header of its own, renames the library
    (no stale build is loaded); an edit to a header it does not include does
    not."""
    (tmp_path / "a" / "csrc").mkdir(parents=True)
    (tmp_path / "shared").mkdir()
    src = tmp_path / "a" / "csrc" / "a.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "own.cuh"\n')
    (tmp_path / "a" / "csrc" / "own.cuh").write_text('#pragma once\n#include "../../shared/s.cuh"\n')
    shared = tmp_path / "shared" / "s.cuh"
    shared.write_text("#pragma once\n")
    other = tmp_path / "a" / "csrc" / "unused.cuh"
    other.write_text("#pragma once\n")
    monkeypatch.setattr(_build, "source", lambda name: src)
    assert [p.name for p in _build.includes(src)] == ["own.cuh", "s.cuh"]
    before = _build.library_path("a")
    shared.write_text("#pragma once\n// edited\n")
    after = _build.library_path("a")
    assert after != before
    other.write_text("#pragma once\n// edited\n")
    assert _build.library_path("a") == after


@pytest.mark.parametrize("name", ["rolann_stats", "ssd_chunk"])
def test_tensor_core_sources_hash_the_shared_header(name):
    shared = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "tf32x3_sm90.cuh"
    assert shared.resolve() in _build.includes(_build.source(name))


def test_fleet_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from repro_torch.core import federated, fleet
    from repro_torch.engine import DAEFEngine, ExecutionPlan

    cfg = daef.DAEFConfig(layer_sizes=(4, 2, 4))
    xs = np.random.default_rng(0).normal(size=(2, 4, 40)).astype(np.float32)
    fl = fleet._fit_fleet(cfg, xs, device="cpu")
    state = (fl.model.encoder_factors, fl.model.layer_knowledge, fl.model.train_errors)
    leaves = interop.exchange_state_to_numpy(fleet._tree_map(lambda t: t[0], state))
    _no_card(monkeypatch)
    calls = [
        lambda: DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=2)),
        lambda: DAEFEngine(cfg, ExecutionPlan(federation="async")),
        lambda: federated._federated_fit(cfg, [xs[0], xs[1]]),
        lambda: federated.train_locally_and_aggregate(cfg, [xs[0]]),
        lambda: federated.additive_to_exchange(cfg, [np.eye(4), np.eye(3), np.ones((4, 3)),
                                                     np.ones(64)]),
        lambda: interop.exchange_state_from_numpy(cfg, leaves),
        lambda: fleet._fit_fleet(cfg, xs),
        lambda: fleet._fit_fleet_chunked(cfg, xs, chunk_samples=16),
        lambda: fleet._fit_fleet_stream(cfg, [xs[..., :20], xs[..., 20:]]),
        lambda: fleet.fleet_predict(cfg, fl, xs),
        lambda: fleet.fleet_scores(cfg, fl, xs),
        lambda: fleet.fleet_partial_fit(cfg, fl, xs),
        lambda: fleet.fleet_classify(np.zeros((2, 3)), np.zeros(2)),
        lambda: interop.fleet_from_numpy(cfg, interop.fleet_to_numpy(fl)),
        lambda: rolann.init_stats(2, 4, activations.logsig, tenants=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="none is present"):
            call()
    # what works on a fleet's tensors stays on their device
    assert fleet.fleet_thresholds(fl).device.type == "cpu"
    assert fleet.fleet_merge_pairwise(cfg, fl).size == 1
