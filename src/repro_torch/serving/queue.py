"""Per-tenant scoring request queue for the fleet serving layer (a copy of
``repro/serving/queue.py``).

A ``ScoreRequest`` is one tenant's batch of samples to score
(``[features, n]``); the queue holds the columns that still need a scoring
dispatch (cache hits are stripped before enqueue) as per-tenant FIFO spans,
and hands them to the `packer.TilePacker` in round-robin tenant order so a
burst from one tenant cannot starve the rest.

Requests are host-side bookkeeping only — nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

import numpy as np


@dataclasses.dataclass
class ScoreRequest:
    """One tenant's scoring request and its (partially) filled results.

    ``scores``/``flags`` fill in as tiles complete (cache hits fill
    immediately); the request is done when ``pending`` reaches zero.
    """

    request_id: int
    tenant: int
    x: np.ndarray                # [m0, n] float32 — the samples to score
    scores: np.ndarray           # [n] float32, NaN until filled
    flags: np.ndarray            # [n] int32
    pending: int                 # columns still awaiting a dispatch
    cached_cols: int = 0         # columns answered from the score cache
    hashes: list | None = None   # per-column cache keys (cache enabled only)

    @property
    def done(self) -> bool:
        return self.pending == 0

    @property
    def n_samples(self) -> int:
        return self.x.shape[1]


class _Span:
    """A contiguous run of still-unscored columns of one request."""

    __slots__ = ("request", "cols")

    def __init__(self, request: ScoreRequest, cols: np.ndarray):
        self.request = request
        self.cols = cols


class RequestQueue:
    """Round-robin per-tenant FIFO of pending scoring work."""

    def __init__(self):
        self._spans: "OrderedDict[int, deque[_Span]]" = OrderedDict()
        self._counts: dict[int, int] = {}
        self.pending_samples = 0

    def __bool__(self) -> bool:
        return self.pending_samples > 0

    def __len__(self) -> int:
        return self.pending_samples

    @property
    def pending_tenants(self) -> int:
        return len(self._spans)

    def push(self, request: ScoreRequest, cols: np.ndarray) -> None:
        """Enqueue ``cols`` (column indices into ``request.x``) for scoring."""
        if cols.size == 0:
            return
        self._spans.setdefault(request.tenant, deque()).append(
            _Span(request, np.asarray(cols, np.int64))
        )
        n = int(cols.size)
        self._counts[request.tenant] = self._counts.get(request.tenant, 0) + n
        self.pending_samples += n

    def next_tenant(self) -> int | None:
        """The tenant whose work the next tile slot should take (FIFO over
        tenants; `rotate` moves it to the back once its slot is cut)."""
        if not self._spans:
            return None
        return next(iter(self._spans))

    def pending_for(self, tenant: int) -> int:
        """Columns still queued for ``tenant``."""
        return self._counts.get(tenant, 0)

    def largest_tenant(self) -> int | None:
        """The tenant with the most queued columns (ties break FIFO).

        Largest-first slot filling keeps each tile width-homogeneous: wide
        bursts fill the early tiles at full width, the trickle of small
        requests ends up together in a final narrow tile — instead of one
        burst span stretching the tile width every small span pads to.
        """
        if not self._counts:
            return None
        return max(self._counts, key=self._counts.__getitem__)

    def rotate(self, tenant: int) -> None:
        """Move ``tenant`` to the back of the round-robin order."""
        if tenant in self._spans:
            self._spans.move_to_end(tenant)

    def take(self, tenant: int, limit: int) -> tuple[ScoreRequest, np.ndarray] | None:
        """Pop up to ``limit`` columns of ``tenant``'s oldest span.

        Returns ``(request, cols)`` or None when the tenant has no pending
        work.  A span wider than ``limit`` is split; the remainder stays at
        the FRONT of the tenant's deque so a request's columns stay ordered.
        """
        spans = self._spans.get(tenant)
        if not spans:
            return None
        span = spans[0]
        if span.cols.size <= limit:
            spans.popleft()
            cols = span.cols
        else:
            cols = span.cols[:limit]
            span.cols = span.cols[limit:]
        if not spans:
            del self._spans[tenant]
        n = int(cols.size)
        self.pending_samples -= n
        remaining = self._counts[tenant] - n
        if remaining:
            self._counts[tenant] = remaining
        else:
            del self._counts[tenant]
        return span.request, cols
