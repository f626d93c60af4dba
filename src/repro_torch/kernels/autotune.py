"""The measured einsum-vs-fused verdict per platform, from a committed cache
(counterpart of ``repro/kernels/autotune.py``).

``stats_backend.resolve("auto")`` asks :func:`preferred_backend` which Gram
statistics producer to run on the device the fold runs on.  The verdict is
a measurement: ``scripts/torch_kernel_autotune.py --write-cache`` times the
einsum route against the fused CUDA kernel on the card and records the
faster under ``"cuda"``.  Nobody writes it by hand.

Cache format (one file, one JSON object), the reference's::

    {
      "version": 1,
      "platforms": {
        "<platform>": {
          "preferred_backend": "einsum" | "fused",
          "blocks": {"<kind>:n<2^a>:m<2^b>:o<2^c>": <block_n>, ...}
        }
      }
    }

The platform is ``"cuda"`` for the card and ``"cpu"`` for the host, so a
file written by the JAX package (``"cpu"``, ``"gpu"``, ``"tpu"``) never
answers for the port's kernels on the card.  The reference's ``blocks``
tune its Pallas kernels' sample-axis block; no CUDA wrapper of the port
takes one (each plans its slices from the card's SM count), so nothing here
reads them, and :func:`update_cache` keeps a map it is given so the format
round-trips.  A corrupt file, a wrong version or an unknown backend
resolves to ``"einsum"`` with a one-time warning: a broken file can slow a
fit down, never break it.
"""
from __future__ import annotations

import json
import os
import warnings
from pathlib import Path

import torch

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
DEFAULT_CACHE_PATH = Path(__file__).resolve().parent / "autotune_cache.json"
CACHE_VERSION = 1

#: Concrete stats backends a cache may prefer (``stats_backend.BACKENDS``,
#: spelled out because ``stats_backend`` imports this module).
_KNOWN_BACKENDS = ("einsum", "fused")

# In-memory copy of the cache file, loaded once per (path, process) and
# dropped by `clear_cache()` (tests point $REPRO_AUTOTUNE_CACHE at fixtures).
_cache: dict | None = None
_cache_src: str | None = None
_warned: set[str] = set()


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def cache_path() -> Path:
    """Active cache file: ``$REPRO_AUTOTUNE_CACHE`` or the committed one."""
    override = os.environ.get(CACHE_ENV)
    return Path(override) if override else DEFAULT_CACHE_PATH


def _warn_once(key: str, message: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=3)


def clear_cache() -> None:
    """Drop the in-memory cache (and the warnings' dedup) so the next lookup
    re-reads the file."""
    global _cache, _cache_src
    _cache = None
    _cache_src = None
    _warned.clear()


def load_cache(path: str | Path | None = None) -> dict:
    """The parsed cache object ({} when missing or corrupt, with a warning).

    Loaded once per process per path; bad JSON, a wrong version or a
    non-object layout degrades to an empty cache, where ``"auto"`` resolves
    to einsum.
    """
    global _cache, _cache_src
    p = Path(path) if path is not None else cache_path()
    if _cache is not None and _cache_src == str(p):
        return _cache
    loaded: dict = {}
    if p.exists():
        try:
            raw = json.loads(p.read_text())
            if not isinstance(raw, dict):
                raise ValueError(f"top level is {type(raw).__name__}, not an object")
            if raw.get("version") != CACHE_VERSION:
                raise ValueError(f"cache version {raw.get('version')!r} != {CACHE_VERSION}")
            if not isinstance(raw.get("platforms", {}), dict):
                raise ValueError("'platforms' is not an object")
            loaded = raw
        except (ValueError, OSError) as e:
            _warn_once(
                f"corrupt:{p}",
                f"autotune cache {p} is unreadable ({e}); 'auto' resolves to "
                "'einsum' — regenerate with scripts/torch_kernel_autotune.py "
                "--write-cache",
            )
            loaded = {}
    _cache, _cache_src = loaded, str(p)
    return loaded


def platform_of(device: str | torch.device | None = None) -> str:
    """The cache's platform key of ``device``: ``"cuda"`` for a CUDA device,
    ``"cpu"`` otherwise; ``None`` is the port's default device, the card
    where one is present."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def shape_key(kind: str, *, n: int, m: int, o: int) -> str:
    """Bucketed cache key for one kernel launch shape (the reference's)."""
    return f"{kind}:n{next_pow2(n)}:m{next_pow2(m)}:o{next_pow2(o)}"


def preferred_backend(platform: str | None = None) -> str:
    """Measured stats-backend winner for ``platform`` (``"auto"``'s answer;
    ``None``: :func:`platform_of` the default device).  Anything missing or
    unrecognised resolves to ``"einsum"``."""
    plat = platform if platform is not None else platform_of()
    entry = load_cache().get("platforms", {}).get(plat, {})
    pref = entry.get("preferred_backend") if isinstance(entry, dict) else None
    if pref in _KNOWN_BACKENDS:
        return pref
    if pref is not None:
        _warn_once(
            f"pref:{plat}",
            f"autotune cache names unknown preferred_backend {pref!r} for "
            f"platform {plat!r}; resolving 'auto' to 'einsum'",
        )
    return "einsum"


def update_cache(
    *,
    platform: str,
    blocks: dict[str, int] | None = None,
    preferred: str | None = None,
    path: str | Path | None = None,
) -> dict:
    """Merge measured winners into the cache file (and the in-memory copy).

    ``preferred`` records the einsum-vs-fused verdict; ``blocks`` maps
    :func:`shape_key` strings to block sizes (kept for the format).  Entries
    of other platforms and keys are preserved.
    """
    p = Path(path) if path is not None else cache_path()
    cache = dict(load_cache(p))
    cache["version"] = CACHE_VERSION
    platforms = dict(cache.get("platforms", {}))
    entry = dict(platforms.get(platform, {}))
    if blocks:
        merged = dict(entry.get("blocks", {}))
        merged.update(blocks)
        entry["blocks"] = dict(sorted(merged.items()))
    if preferred is not None:
        if preferred not in _KNOWN_BACKENDS:
            raise ValueError(f"preferred backend {preferred!r} not in {_KNOWN_BACKENDS}")
        entry["preferred_backend"] = preferred
    platforms[platform] = entry
    cache["platforms"] = dict(sorted(platforms.items()))
    p.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
    clear_cache()
    load_cache(p)
    return cache


__all__ = ["CACHE_ENV", "DEFAULT_CACHE_PATH", "cache_path", "clear_cache", "load_cache",
           "next_pow2", "platform_of", "preferred_backend", "shape_key", "update_cache"]
