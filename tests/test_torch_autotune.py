"""repro_torch.kernels.autotune and the measured ``stats_backend="auto"``
against repro.kernels.autotune.

* The cache's mechanics, as the reference's ``tests/test_autotune.py``
  holds them: a corrupt file, a wrong version or a non-object layout reads
  as an empty cache with one warning; an unknown ``preferred_backend``
  resolves to ``"einsum"`` with one warning; ``update_cache`` merges
  platforms and keys and writes the reference's layout (a file either
  package writes, the other reads alike).
* The committed cache parses, and the host's platform ``"cpu"`` prefers
  ``einsum`` (on the host the fused wrapper runs the plain version).
* ``resolve("auto", device)`` follows the cache by the device's platform:
  a fixture with ``"cuda": "fused"`` makes the card resolve to ``fused``
  and the host to ``einsum``; a JAX-package ``"gpu"`` entry answers
  nothing.  Resolution launches nothing, so no card is needed.
* Every entry point resolves ``"auto"`` with the device its data lies on.

Each test points ``$REPRO_AUTOTUNE_CACHE`` at its own file and clears both
packages' in-memory caches on both sides.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jtune
from repro_torch.core import daef, stats_backend
from repro_torch.engine import DAEFEngine, ExecutionPlan
from repro_torch.kernels import autotune


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache.json"))
    monkeypatch.delenv(stats_backend.ENV_VAR, raising=False)
    autotune.clear_cache()
    jtune.clear_cache()
    yield
    autotune.clear_cache()
    jtune.clear_cache()


def _write(obj) -> None:
    autotune.cache_path().write_text(obj if isinstance(obj, str) else json.dumps(obj))


def test_names_match_the_reference():
    assert autotune.CACHE_ENV == jtune.CACHE_ENV
    assert autotune.CACHE_VERSION == jtune.CACHE_VERSION
    assert autotune.DEFAULT_CACHE_PATH.name == jtune.DEFAULT_CACHE_PATH.name
    assert autotune.DEFAULT_CACHE_PATH != jtune.DEFAULT_CACHE_PATH
    for n in (0, 1, 2, 3, 100, 1024, 1025):
        assert autotune.next_pow2(n) == jtune.next_pow2(n)
    assert (autotune.shape_key("stats_acc", n=3000, m=8, o=7)
            == jtune.shape_key("stats_acc", n=3000, m=8, o=7) == "stats_acc:n4096:m8:o8")


@pytest.mark.parametrize("content,needle", [
    ("{not json", "unreadable"),
    (json.dumps({"version": 99, "platforms": {}}), "version"),
    (json.dumps([1, 2]), "not an object"),
    (json.dumps({"version": 1, "platforms": [1]}), "'platforms' is not an object"),
])
def test_corrupt_cache_warns_once_and_resolves_einsum(content, needle):
    _write(content)
    with pytest.warns(RuntimeWarning, match=needle):
        assert autotune.load_cache() == {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", category=RuntimeWarning)
        assert autotune.preferred_backend("cuda") == "einsum"
        assert stats_backend.resolve("auto", "cuda") == "einsum"


def test_unknown_preferred_backend_warns_to_einsum():
    _write({"version": 1, "platforms": {"cuda": {"preferred_backend": "cuda_graphs"}}})
    with pytest.warns(RuntimeWarning, match="unknown preferred_backend"):
        assert autotune.preferred_backend("cuda") == "einsum"
    with warnings.catch_warnings():
        warnings.simplefilter("error", category=RuntimeWarning)
        assert autotune.preferred_backend("cuda") == "einsum"


def test_update_cache_merges_platforms_in_the_references_layout():
    key = autotune.shape_key("stats", n=700, m=8, o=8)
    autotune.update_cache(platform="cpu", blocks={key: 512}, preferred="einsum")
    autotune.update_cache(platform="cuda", preferred="fused")
    autotune.update_cache(platform="cpu", blocks={"stats:n256:m8:o8": 256})
    raw = json.loads(autotune.cache_path().read_text())
    assert raw == {"version": 1, "platforms": {
        "cpu": {"preferred_backend": "einsum",
                "blocks": {key: 512, "stats:n256:m8:o8": 256}},
        "cuda": {"preferred_backend": "fused"}}}
    assert autotune.preferred_backend("cuda") == "fused"
    # the reference reads the port's file alike (and answers only its own keys)
    assert jtune.preferred_backend("cuda") == "fused"
    assert jtune.lookup_block("stats", n=700, m=8, o=8, platform="cpu") == 512
    with pytest.raises(ValueError, match="not in"):
        autotune.update_cache(platform="cuda", preferred="pallas")


def test_committed_cache_parses(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV)
    autotune.clear_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error", category=RuntimeWarning)
        raw = autotune.load_cache()
    assert raw["version"] == 1 and set(raw["platforms"]) <= {"cpu", "cuda"}
    assert autotune.preferred_backend("cpu") == "einsum"
    assert autotune.preferred_backend("cuda") in stats_backend.BACKENDS
    assert stats_backend.resolve("auto", "cpu") == "einsum"


def test_resolve_auto_follows_the_devices_platform():
    assert stats_backend.resolve("auto", "cuda") == "einsum"   # unmeasured
    _write({"version": 1, "platforms": {"gpu": {"preferred_backend": "fused"},
                                         "cuda": {"preferred_backend": "fused"}}})
    autotune.clear_cache()
    assert stats_backend.resolve("auto", "cuda") == "fused"
    assert stats_backend.resolve("auto", torch.device("cuda", 0)) == "fused"
    assert stats_backend.resolve(None, "cuda") == "fused"
    assert stats_backend.resolve("auto", "cpu") == "einsum"
    assert stats_backend.resolve("einsum", "cuda") == "einsum"   # explicit first
    _write({"version": 1, "platforms": {"gpu": {"preferred_backend": "fused"}}})
    autotune.clear_cache()
    assert stats_backend.resolve("auto", "cuda") == "einsum"     # "gpu" is the JAX package's


def test_env_outranks_auto(monkeypatch):
    _write({"version": 1, "platforms": {"cuda": {"preferred_backend": "fused"}}})
    monkeypatch.setenv(stats_backend.ENV_VAR, "einsum")
    assert stats_backend.resolve(None, "cuda") == "einsum"
    monkeypatch.setenv(stats_backend.ENV_VAR, "auto")
    assert stats_backend.resolve(None, "cuda") == "fused"


def test_default_device_is_the_card_where_one_is_present(monkeypatch):
    _write({"version": 1, "platforms": {"cuda": {"preferred_backend": "fused"}}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert autotune.platform_of(None) == "cuda"
    assert stats_backend.resolve("auto") == "fused"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.platform_of(None) == "cpu"
    assert stats_backend.resolve("auto") == "einsum"


def test_entry_points_resolve_for_their_data(monkeypatch):
    """With a fixture that prefers the kernel on the card and einsum on the
    host, a host fit, engine and DP fit take einsum, and a config resolved
    for the card takes fused; nothing is launched."""
    _write({"version": 1, "platforms": {"cuda": {"preferred_backend": "fused"},
                                         "cpu": {"preferred_backend": "einsum"}}})
    cfg = daef.DAEFConfig(layer_sizes=(4, 2, 4))
    assert cfg.resolved("cuda").stats_backend == "fused"
    assert cfg.resolved("cpu").stats_backend == "einsum"
    assert DAEFEngine(cfg, device="cpu").config.stats_backend == "einsum"
    seen = []
    real = stats_backend.gram_stats

    def spy(xa, fsq, fd, *, backend=None):
        seen.append(backend)
        return real(xa, fsq, fd, backend=backend)

    monkeypatch.setattr(stats_backend, "gram_stats", spy)
    x = np.random.default_rng(0).normal(size=(4, 30)).astype(np.float32)
    daef.fit(daef.DAEFConfig(layer_sizes=(4, 2, 3, 4)), x, device="cpu")
    assert seen == ["einsum"]
