"""Runtime capture/load budget auditing: :func:`trace_guard` (counterpart of
``repro/analysis/retrace.py``).

The reference stakes its speed on bounded tracing: ``FleetServer.warmup()``
pre-traces every tile shape so a mixed ragged serve never retraces, and the
chunked fit re-traces one step per layer, flat in the number of chunks.  A
torch program traces no jaxprs.  Its counterparts of a trace and a compile
are the two one-time costs on the port's hot paths:

* a **capture** (``traces``) — one CUDA graph captured: a tile shape of
  `serving.server._TileGraph`, the autoencoder baseline's step
  (`baselines.autoencoder._Trainer.capture`);
* a **load** (``compiles``) — one kernel library opened by
  `kernels._build.load` (``ctypes.CDLL``), whether or not ``nvcc`` ran to
  build it: the first open in a process, or the first after
  `kernels._build.clear_loaded`, the counterpart of ``jax.clear_caches()``
  for a cold count.

``trace_guard`` turns a budget into an assertion::

    with trace_guard(max_traces=0, max_compiles=0):
        for _ in range(rounds):
            server.submit(...); server.flush()      # raises on any capture

    with trace_guard() as rep:                      # measure, don't enforce
        fleet._fit_fleet_chunked(cfg, xs, chunk_samples=32)
    assert rep.compiles == expected

The counts come from the small recorder below: the capture and load sites
call :func:`record` with :data:`GRAPH_CAPTURE_EVENT` or
:data:`LIBRARY_LOAD_EVENT` and a name.  The module imports nothing of the
rest of the package, so those sites can import it freely.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

GRAPH_CAPTURE_EVENT = "/repro_torch/cuda_graph/capture"
LIBRARY_LOAD_EVENT = "/repro_torch/kernels/library_load"

_COUNTS = {GRAPH_CAPTURE_EVENT: 0, LIBRARY_LOAD_EVENT: 0}
_NAMES: list[str] = []


def record(event: str, name: str) -> None:
    """Count one ``event`` (a capture or a load) of ``name``."""
    _COUNTS[event] += 1
    _NAMES.append(name)


def trace_counts() -> tuple[int, int]:
    """Process-lifetime ``(captures, loads)`` counted so far."""
    return _COUNTS[GRAPH_CAPTURE_EVENT], _COUNTS[LIBRARY_LOAD_EVENT]


class TraceBudgetExceeded(AssertionError):
    """Raised by :func:`trace_guard` when the block captured or loaded more
    than its budget allows."""


@dataclass
class TraceReport:
    """Deltas observed inside one :func:`trace_guard` block: ``traces``
    counts CUDA-graph captures, ``compiles`` kernel-library loads, and
    ``traced_names`` names the captured functions and the libraries."""

    traces: int = 0
    compiles: int = 0
    traced_names: list[str] = field(default_factory=list)
    _start: tuple[int, int] = (0, 0)
    _names_at: int = 0

    def snapshot(self) -> None:
        t, c = trace_counts()
        self.traces = t - self._start[0]
        self.compiles = c - self._start[1]
        self.traced_names = _NAMES[self._names_at:]

    def __str__(self) -> str:
        names = f" ({', '.join(sorted(set(self.traced_names)))})" \
            if self.traced_names else ""
        return f"TraceReport(traces={self.traces}, " \
               f"compiles={self.compiles}{names})"


@contextmanager
def trace_guard(max_traces: int | None = None, *,
                max_compiles: int | None = None, what: str = "block"):
    """Count CUDA-graph captures and library loads in the ``with`` block;
    optionally enforce.

    Args:
      max_traces: if given, raise :class:`TraceBudgetExceeded` when the
        block captured more than this many CUDA graphs (``0`` asserts
        "fully warm — no capture at all").  ``None`` = measure only.
      max_compiles: same for kernel-library loads.
      what: label used in the failure message.

    Yields a :class:`TraceReport` whose ``traces``/``compiles`` are live
    (updated on exit and via ``snapshot()``).  Nested guards are fine —
    each sees its own deltas.  A cold call may load several libraries (one
    per kernel family it reaches), so budgets mean "at most N" for cold
    paths and the exact ``0`` for warm paths; flatness claims should
    compare deltas of two runs.
    """
    report = TraceReport(_start=trace_counts(), _names_at=len(_NAMES))
    try:
        yield report
    finally:
        report.snapshot()
    if max_traces is not None and report.traces > max_traces:
        raise TraceBudgetExceeded(
            f"{what}: {report.traces} CUDA-graph capture(s), budget {max_traces}"
            + (f"; captured: {sorted(set(report.traced_names))}"
               if report.traced_names else "")
        )
    if max_compiles is not None and report.compiles > max_compiles:
        raise TraceBudgetExceeded(
            f"{what}: {report.compiles} kernel-library load(s), budget "
            f"{max_compiles}; loaded: {sorted(set(report.traced_names))}"
        )


__all__ = ["trace_guard", "trace_counts", "TraceReport",
           "TraceBudgetExceeded", "GRAPH_CAPTURE_EVENT",
           "LIBRARY_LOAD_EVENT", "record"]
