"""Score / threshold cache keyed on ``(tenant, model_version)`` (a copy of
``repro/serving/cache.py``).

Scoring is deterministic given the model — the same sample scored against
the same tenant model always produces the same reconstruction error.  The
cache exploits that: scores key on ``(tenant, model_version, sample_hash)``
(the hash is over the sample's float32 bytes), so a request whose samples
were already scored against an UNCHANGED tenant skips the scoring dispatch
entirely.  Any retrain bumps the engine's model version
(`DAEFEngine.model_version`), which changes every key — stale entries are
never served and age out of the LRU ring.

Thresholds cache per ``(tenant, model_version)`` the same way: re-derived
from the recalibration sketches once per version, served from the dict
after.
"""
from __future__ import annotations

import hashlib
from itertools import islice

import numpy as np


def sample_hashes(x: np.ndarray) -> list[bytes]:
    """Per-column content keys of a ``[m0, n]`` float32 sample batch.

    Small samples key on their raw bytes (exact, collision-free, no hash
    cost on the serving hot path); wide feature vectors (> 256 bytes)
    compress to a 16-byte blake2b digest.
    """
    cols = np.ascontiguousarray(np.asarray(x, np.float32).T)
    n, m0 = cols.shape
    raw = cols.view(np.dtype((np.void, m0 * 4))).ravel()
    if m0 * 4 <= 256:
        return [bytes(v) for v in raw]
    return [
        hashlib.blake2b(bytes(v), digest_size=16).digest() for v in raw
    ]


class ScoreCache:
    """Bounded map of per-sample scores, versioned per tenant model.

    Eviction is insertion-ordered (FIFO) rather than strict LRU: the
    serving hot path does thousands of lookups per round, and per-hit
    recency bookkeeping costs more than the occasional extra miss —
    versioned keys age out on every retrain anyway.
    """

    def __init__(self, max_entries: int = 1 << 17):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._scores: dict[tuple, float] = {}
        self._thresholds: dict[tuple, float] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._scores)

    # ------------------------------------------------------------------
    # Scores
    # ------------------------------------------------------------------

    def get(self, tenant: int, version: int, h: bytes) -> float | None:
        score = self._scores.get((tenant, version, h))
        if score is None:
            self.misses += 1
            return None
        self.hits += 1
        return score

    def get_many(
        self, tenant: int, version: int, hashes: list[bytes]
    ) -> tuple[list[int], list[float], list[int]]:
        """Batched lookup: ``(hit_cols, hit_scores, miss_cols)`` over the
        column indices of ``hashes``."""
        scores = self._scores
        hit_j: list[int] = []
        hit_s: list[float] = []
        miss: list[int] = []
        for j, h in enumerate(hashes):
            s = scores.get((tenant, version, h))
            if s is None:
                miss.append(j)
            else:
                hit_j.append(j)
                hit_s.append(s)
        self.hits += len(hit_j)
        self.misses += len(miss)
        return hit_j, hit_s, miss

    def put(self, tenant: int, version: int, h: bytes, score: float) -> None:
        self._scores[(tenant, version, h)] = score
        self._trim()

    def put_many(self, tenant: int, version: int, hashes, scores) -> None:
        d = self._scores
        for h, s in zip(hashes, scores, strict=True):
            d[(tenant, version, h)] = s
        self._trim()

    def _trim(self) -> None:
        over = len(self._scores) - self.max_entries
        if over > 0:
            for k in list(islice(iter(self._scores), over)):
                del self._scores[k]

    # ------------------------------------------------------------------
    # Thresholds
    # ------------------------------------------------------------------

    def get_threshold(self, tenant: int, version: int) -> float | None:
        return self._thresholds.get((tenant, version))

    def put_threshold(self, tenant: int, version: int, mu: float) -> None:
        self._thresholds[(tenant, version)] = mu

    def drop_stale(self, version: int) -> int:
        """Evict every entry older than ``version`` (optional hygiene —
        stale keys can never hit, this just frees them eagerly).  Returns
        the number of score entries dropped."""
        stale = [k for k in self._scores if k[1] < version]
        for k in stale:
            del self._scores[k]
        for k in [k for k in self._thresholds if k[1] < version]:
            del self._thresholds[k]
        return len(stale)

    def __repr__(self) -> str:
        total = self.hits + self.misses
        rate = self.hits / total if total else 0.0
        return (f"ScoreCache(entries={len(self._scores)}, hits={self.hits}, "
                f"misses={self.misses}, hit_rate={rate:.2%})")
