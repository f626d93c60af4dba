"""Continuous batching: pack ragged per-tenant queues into dense tiles (a
copy of ``repro/serving/packer.py``).

The pad-to-max baseline (`launch/serve.py --packing pad`) gives every tenant
one slot per dispatch and pads the sample axis to the widest request — under
mixed ragged traffic most of the dispatched columns are padding.  The packer
instead fills a ``[slots, m0, width]`` tile from WHICHEVER tenants have
pending work: a slot belongs to one tenant (its model scores the whole
slot), consecutive work items of that tenant coalesce until the slot is
full, and each slot carries ``(tenant, request_id)`` routing metadata so the
server can scatter scores back to the right requests.

Tiles shrink to the work available: the used slot count rounds up to the
{2^k, 3*2^(k-1)} ladder and the sample width to a power of two (a bounded
set of shapes — `TilePacker.shapes` enumerates every tile shape that can
ever be packed; `FleetServer.warmup` captures one CUDA graph for each) and the buffers are cut to that, so a trickle of requests
dispatches a small tile instead of the full fleet shape.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.serving.queue import RequestQueue, ScoreRequest


class SlotAssignment(NamedTuple):
    """Routing metadata: which request columns live where in the tile."""

    slot: int
    tenant: int
    request: ScoreRequest
    cols: np.ndarray     # column indices into request.x
    start: int           # first tile column the run occupies
    sl: slice | None = None   # slice view of cols when contiguous (fast copy)


@dataclasses.dataclass
class Tile:
    """One dense scoring dispatch: data + per-slot routing."""

    x: np.ndarray             # [S, m0, T] float32
    slot_tenants: np.ndarray  # [S] int32 (unused slots point at tenant 0)
    n_valid: np.ndarray       # [S] int32 — filled columns per slot
    assignments: list[SlotAssignment]

    @property
    def n_samples(self) -> int:
        return int(self.n_valid.sum())

    @property
    def shape(self) -> tuple:
        return self.x.shape


def _next_pow2(n: int, lo: int) -> int:
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _next_ladder(n: int, lo: int) -> int:
    """Round up to the {2^k, 3*2^(k-1)} ladder (1, 2, 3, 4, 6, 8, 12, ...).

    Finer than pow2 rounding (at most 1/3 slack instead of 2x) at the cost
    of ~2x more tile shapes — used for the slot axis, where a 17-slot
    tile rounded to 32 would dispatch 15 fully-empty slots at tile width.
    """
    n = max(n, lo)
    p = 1 << (n - 1).bit_length()
    mid = 3 * (p // 4)
    return mid if n <= mid and mid >= lo else p


class TilePacker:
    """Fill dense ``[slots, m0, width]`` tiles from a `RequestQueue`."""

    def __init__(self, m0: int, *, slots: int = 32, width: int = 32,
                 min_slots: int = 1, min_width: int = 8,
                 order: str = "largest"):
        if slots < 1 or width < 1:
            raise ValueError(f"need slots >= 1 and width >= 1, got "
                             f"slots={slots}, width={width}")
        if order not in ("largest", "fifo"):
            raise ValueError(f"order must be 'largest' or 'fifo', got "
                             f"{order!r}")
        self.m0 = m0
        self.slots = slots
        self.width = width
        self.min_slots = min(min_slots, slots)
        self.min_width = min(min_width, width)
        self.order = order

    def shapes(self) -> list[tuple[int, int]]:
        """Every ``(slots, width)`` tile shape this packer can emit —
        the set `FleetServer.warmup` captures a CUDA graph for."""
        slot_sizes = []
        s = _next_ladder(1, self.min_slots)
        while s < self.slots:
            slot_sizes.append(s)
            s = _next_ladder(s + 1, self.min_slots)
        slot_sizes.append(self.slots)
        widths = []
        t = _next_pow2(1, self.min_width)
        while t < self.width:
            widths.append(t)
            t *= 2
        widths.append(self.width)
        return [(s, t) for s in slot_sizes for t in widths]

    def pack(self, queue: RequestQueue) -> Tile | None:
        """Cut one tile's worth of work from the queue (None when empty).

        Slots fill largest-pending-tenant-first by default, so each tile is
        width-homogeneous (bursts pack densely at full width, small requests
        share a later narrow tile).  ``order='fifo'`` keeps strict
        round-robin arrival order instead — fairer under sustained
        overload, at the cost of wide spans stretching the tile width that
        every co-packed small span pads to.
        """
        if not queue:
            return None
        assignments: list[SlotAssignment] = []
        fills: list[int] = []
        for slot in range(self.slots):
            tenant = (queue.largest_tenant() if self.order == "largest"
                      else queue.next_tenant())
            if tenant is None:
                break
            # Width homogeneity: once the tile holds wide slots, defer
            # tenants whose whole backlog is < 1/8 of the tile's widest
            # fill — they'd pad their slot to that width; a later narrow
            # tile packs them densely instead.
            if (self.order == "largest" and fills
                    and min(queue.pending_for(tenant), self.width) * 8
                    < max(fills)):
                break
            filled = 0
            while filled < self.width:
                item = queue.take(tenant, self.width - filled)
                if item is None:
                    break
                request, cols = item
                # Columns are usually an unbroken run (cache misses can
                # puncture it); a slice copy beats a fancy-index gather.
                c0, c1 = int(cols[0]), int(cols[-1])
                sl = slice(c0, c1 + 1) if c1 - c0 + 1 == cols.size else None
                assignments.append(
                    SlotAssignment(slot, tenant, request, cols, filled, sl)
                )
                filled += int(cols.size)
            fills.append(filled)
            queue.rotate(tenant)
        # Cut the buffers to the work: rounded used slots/width keep the
        # set of tile shapes (one CUDA graph each) small while staying dense.
        s_used = _next_ladder(len(fills), self.min_slots)
        t_used = _next_pow2(max(fills), self.min_width)
        s_used, t_used = min(s_used, self.slots), min(t_used, self.width)
        x = np.zeros((s_used, self.m0, t_used), np.float32)
        for a in assignments:
            src = a.request.x[:, a.sl if a.sl is not None else a.cols]
            x[a.slot, :, a.start:a.start + a.cols.size] = src
        slot_tenants = np.zeros(s_used, np.int32)
        n_valid = np.zeros(s_used, np.int32)
        for slot, filled in enumerate(fills):
            n_valid[slot] = filled
        for a in assignments:
            slot_tenants[a.slot] = a.tenant
        return Tile(x=x, slot_tenants=slot_tenants, n_valid=n_valid,
                    assignments=assignments)
