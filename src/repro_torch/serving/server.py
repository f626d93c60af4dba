"""FleetServer — the production serving loop over a trained DAEF fleet
(counterpart of ``repro/serving/server.py``).

Ties the serving pieces together on top of `DAEFEngine`:

* **continuous batching** — `submit` strips cache hits and queues the rest;
  `step` packs a dense ``[S, m0, T]`` tile from whichever tenants have
  pending work (`packer.TilePacker`) and runs ONE `_score_tile` that
  gathers each slot's tenant model, scores, NaN-masks the slot padding and
  thresholds — scores + flags from a single call (the pad-to-max baseline
  pays two);
* **one CUDA graph per tile shape** — on the card, `warmup` captures
  `_score_tile` once for every shape the packer can emit (the counterpart
  of the reference's pre-trace of every shape).  Each graph reads a static
  tile buffer that every dispatch of its shape reuses (the counterpart of
  the reference's donated tile) and the fleet's leaves and thresholds from
  static buffers that `update_state` refills in place; a dispatch copies
  the tile in and replays.  A capture that fails raises: the card never
  falls back to eager scoring.  On the host, `_score_tile` runs eagerly;
* **deferred device-resident readback** — each replay's scores and flags
  go to pinned host buffers by non-blocking copies, with one CUDA event per
  tile, so nothing waits while up to ``max_inflight`` tiles accumulate;
  `flush` waits on the events and `_harvest` reads the host copies.
  ``readback="per_tile"`` keeps the depth-2 pipeline (tile ``t`` is read
  back once ``t+1`` is in flight);
* **score/threshold cache** — keyed on ``(tenant, model_version,
  sample_hash)`` (`cache.ScoreCache`); requests whose samples were already
  scored against an unchanged tenant complete without any dispatch;
* **online threshold recalibration** — per-tenant additive error sketches
  (`recalibration.ErrorSketch`) fold in ONLY the new block's train errors on
  `partial_fit`/`update_state`, so a fleet retrains and re-serves without a
  stop-the-world quantile pass over every error it ever produced.

None of the scoring is a hand-written kernel: the reference computes it
outside any Pallas kernel, as plain batched matmuls.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis import retrace
from repro_torch.analysis.donation import DonationReport
from repro_torch.core import fleet
from repro_torch.engine.plan import PlanError
from repro_torch.serving import cache as cache_mod
from repro_torch.serving.packer import TilePacker
from repro_torch.serving.queue import RequestQueue, ScoreRequest
from repro_torch.serving.recalibration import ErrorSketch

logger = logging.getLogger("repro_torch.serving")


def _score_tile(config, model, tile, slot_tenants, n_valid, mus):
    """Score one packed tile: gather each slot's tenant leaves, reconstruct
    (`fleet._reconstruct`, batched over the slots), NaN-mask slot padding,
    threshold.  Scores AND flags from one call.

    ``model`` is the pair (weights, biases) of the fleet's leaves, each with
    a leading tenant axis; tile [S, m0, T], slot_tenants [S] and n_valid [S]
    (int64), mus [K].  Returns errs [S, T] float32 and flags [S, T] int32.
    """
    weights, biases = model
    w = tuple(leaf.index_select(0, slot_tenants) for leaf in weights)
    b = tuple(leaf.index_select(0, slot_tenants) for leaf in biases)
    recon = fleet._reconstruct(config, tile, w, b)
    errs = torch.mean((recon - tile) ** 2, dim=1)
    mask = torch.arange(tile.shape[-1], device=tile.device)[None, :] < n_valid[:, None]
    errs = torch.where(mask, errs, torch.nan)
    flags = (errs > mus.index_select(0, slot_tenants)[:, None]).to(torch.int32)
    return errs, flags


class ScoreResult(NamedTuple):
    """A completed request: per-sample scores and anomaly flags."""

    request_id: int
    tenant: int
    scores: np.ndarray   # [n] float32
    flags: np.ndarray    # [n] int32 (NaN-score padding classifies 0)
    cached_cols: int     # how many columns the score cache answered


class _TileGraph:
    """One captured `_score_tile` for one tile shape: the static tile,
    routing buffers and outputs it was captured on."""

    def __init__(self, config, leaves, mus, s: int, m0: int, t: int):
        dev = mus.device
        self.x = torch.zeros((s, m0, t), dtype=torch.float32, device=dev)
        self.meta = torch.zeros((2, s), dtype=torch.int64, device=dev)  # slots, n_valid
        args = (config, leaves, self.x, self.meta[0], self.meta[1], mus)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # lazy library set-up outside the capture
            _score_tile(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.errs, self.flags = _score_tile(*args)
        retrace.record(retrace.GRAPH_CAPTURE_EVENT, f"_score_tile[{s}x{m0}x{t}]")

    def replay(self, x: torch.Tensor, meta: torch.Tensor):
        """Copy a pinned host tile and its routing in, replay; the outputs
        are the graph's static buffers, valid until its next replay."""
        self.x.copy_(x, non_blocking=True)
        self.meta.copy_(meta, non_blocking=True)
        self.graph.replay()
        return self.errs, self.flags


class FleetServer:
    """Continuous-batching scorer for a trained per-tenant fleet.

    >>> server = FleetServer(engine, fl)
    >>> rid = server.submit(tenant=3, x=samples)     # [m0, n] float32
    >>> server.flush()                               # drain the queue
    >>> result = server.take(rid)
    >>> result.scores.shape, result.flags.shape
    ((n,), (n,))

    ``stats`` tracks dispatches / scored samples / cache hit counts — the
    numbers `launch/serve.py --fleet --packing continuous` reports.  The
    server scores on the engine's device.
    """

    def __init__(
        self,
        engine,
        state: fleet.DAEFFleet,
        *,
        slots: int | None = None,
        tile_width: int = 32,
        rule: str = "q95",
        use_cache: bool = True,
        cache_entries: int = 1 << 17,
        sketch_bins: int = 1024,
        readback: str = "deferred",
        max_inflight: int = 32,
    ):
        if readback not in ("deferred", "per_tile"):
            raise PlanError(
                f"readback must be 'deferred' or 'per_tile', got {readback!r}"
            )
        if max_inflight < 1:
            raise PlanError(f"max_inflight must be >= 1, got {max_inflight}")
        if not isinstance(state, fleet.DAEFFleet):
            raise PlanError(
                "FleetServer serves a DAEFFleet; wrap a single model via "
                "fleet.fleet_from_models (1-tenant fleets serve fine)"
            )
        if state.size != engine.plan.tenants:
            raise PlanError(
                f"fleet has {state.size} tenants but the engine plan "
                f"declares tenants={engine.plan.tenants}"
            )
        self.engine = engine
        self.state = state
        self.rule = rule
        self.version = engine.model_version
        self.device = engine.device
        k = state.size
        m0 = engine.config.layer_sizes[0]
        self.packer = TilePacker(m0, slots=min(slots or k, k),
                                 width=tile_width)
        self.queue = RequestQueue()
        self.cache = cache_mod.ScoreCache(cache_entries) if use_cache else None
        self._sketch_bins = sketch_bins
        self.sketches = [ErrorSketch(bins=sketch_bins) for _ in range(k)]
        train_errors = state.model.train_errors.detach().cpu().numpy()
        for t in range(k):
            self.sketches[t].add(train_errors[t])
        self._train_cols = train_errors.shape[-1]
        self._mus: np.ndarray | None = None
        # The scoring inputs every graph reads: the fleet's weights and
        # biases and the thresholds, in buffers refilled in place.
        self._leaves = self._copy_leaves(state)
        self._mus_dev = torch.zeros(k, dtype=torch.float32, device=self.device)
        self._graphs: dict[tuple[int, int], _TileGraph] = {}
        #: One-time donation probe result (filled by `warmup`).
        self.donation: DonationReport | None = None
        self.readback = readback
        self.max_inflight = max_inflight if readback == "deferred" else 1
        self._inflight: deque = deque()
        self._next_id = 0
        self.results: dict[int, ScoreResult] = {}
        self.stats = {
            "submitted": 0, "served": 0, "scored": 0, "dispatches": 0,
            "dispatched_cols": 0, "cache_hit_cols": 0, "recalibrations": 0,
        }

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    @staticmethod
    def _copy_leaves(state: fleet.DAEFFleet):
        m = state.model
        return (tuple(w.detach().clone() for w in m.weights),
                tuple(b.detach().clone() for b in m.biases))

    # ------------------------------------------------------------------
    # Thresholds (sketch-derived, cached per model version)
    # ------------------------------------------------------------------

    @property
    def thresholds(self) -> np.ndarray:
        """Per-tenant mu [K] from the recalibration sketches (lazy, cached
        per (tenant, model_version)); also refills the device copy the
        scoring reads."""
        if self._mus is None:
            mus = np.empty(len(self.sketches), np.float32)
            for t, sk in enumerate(self.sketches):
                mu = self.cache.get_threshold(t, self.version) if self.cache \
                    else None
                if mu is None:
                    mu = sk.threshold(self.rule)
                    if self.cache:
                        self.cache.put_threshold(t, self.version, mu)
                mus[t] = mu
            self._mus = mus
            self._mus_dev.copy_(torch.from_numpy(mus))
        return self._mus

    def probe_donation(self) -> DonationReport:
        """One-time startup probe: is the tile buffer reused?

        On the card the answer is yes by construction — each shape's CUDA
        graph has one static tile buffer, the counterpart of the
        reference's donated tile: ``effective_params`` names the tile
        argument (``(2,)``, its position in `_score_tile`) and ``kinds``
        says ``"graph-static-input"``.  On the host each dispatch scores a
        new tensor: ``effective_params`` is None (``ok`` None, unknown).
        Logs the fact once."""
        if self.donation is None:
            self.donation = DonationReport(
                fn_name=_score_tile.__name__, backend=self.device.type,
                requested=(2,),
                effective_params=(2,) if self._on_card else None,
                kinds=("graph-static-input",) if self._on_card else (),
                warned=False,
            )
            logger.info("%s", self.donation.describe())
        return self.donation

    def _graph(self, s: int, t: int) -> _TileGraph:
        """The CUDA graph of tile shape (s, t), captured on first use."""
        g = self._graphs.get((s, t))
        if g is None:
            m0 = self.engine.config.layer_sizes[0]
            g = _TileGraph(self.engine.config, self._leaves, self._mus_dev, s, m0, t)
            self._graphs[(s, t)] = g
        return g

    def warmup(self) -> int:
        """Prepare every tile shape the packer can emit: on the card, capture
        one CUDA graph per shape (so no capture lands in the serving path);
        on the host, score each shape once eagerly.  Probes the tile buffer
        once (`probe_donation`).  Returns the number of shapes."""
        self.thresholds
        self.probe_donation()
        shapes = self.packer.shapes()
        m0 = self.engine.config.layer_sizes[0]
        for s, t in shapes:
            if self._on_card:
                self._graph(s, t)
            else:
                zeros = torch.zeros(s, dtype=torch.int64)
                _score_tile(self.engine.config, self._leaves,
                            torch.zeros((s, m0, t)), zeros, zeros, self._mus_dev)
        if self._on_card:
            torch.cuda.synchronize(self.device)
        return len(shapes)

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------

    def submit(self, tenant: int, x, request_id: int | None = None) -> int:
        """Queue a scoring request for ``tenant``; returns its request id.

        Samples already scored against this (tenant, model_version) complete
        from the cache without entering the dispatch queue; a request whose
        columns ALL hit finishes immediately.
        """
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        m0 = self.engine.config.layer_sizes[0]
        if x.ndim != 2 or x.shape[0] != m0:
            raise PlanError(
                f"submit: samples must be [features={m0}, n], got "
                f"{x.shape}"
            )
        if not 0 <= tenant < self.state.size:
            raise PlanError(
                f"submit: tenant {tenant} outside fleet of {self.state.size}"
            )
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        n = x.shape[1]
        req = ScoreRequest(
            request_id=request_id, tenant=tenant, x=x,
            scores=np.full(n, np.nan, np.float32),
            flags=np.zeros(n, np.int32), pending=n,
        )
        self.stats["submitted"] += n
        miss_cols = np.arange(n)
        if self.cache is not None:
            req.hashes = cache_mod.sample_hashes(x)
            hit_j, hit_s, misses = self.cache.get_many(
                tenant, self.version, req.hashes
            )
            if hit_j:
                req.scores[hit_j] = hit_s
                req.pending -= len(hit_j)
                req.cached_cols += len(hit_j)
            miss_cols = np.asarray(misses, np.int64)
            self.stats["cache_hit_cols"] += len(hit_j)
        if req.pending == 0:
            self._finish(req)
        else:
            self.queue.push(req, miss_cols)
        return request_id

    # ------------------------------------------------------------------
    # Serving loop
    # ------------------------------------------------------------------

    def _dispatch(self, tile):
        """Score one tile: (errs, flags, event).  On the card a graph replay
        whose outputs are copied to pinned host buffers (valid once the
        event completes); on the host an eager `_score_tile`."""
        meta = np.stack([tile.slot_tenants, tile.n_valid]).astype(np.int64)
        if not self._on_card:
            errs, flags = _score_tile(
                self.engine.config, self._leaves, torch.from_numpy(tile.x),
                torch.from_numpy(meta[0]), torch.from_numpy(meta[1]), self._mus_dev,
            )
            return errs, flags, None
        s, _, t = tile.x.shape
        errs, flags = self._graph(s, t).replay(
            torch.from_numpy(tile.x).pin_memory(), torch.from_numpy(meta).pin_memory())
        errs_h = torch.empty(errs.shape, dtype=errs.dtype, pin_memory=True)
        flags_h = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        errs_h.copy_(errs, non_blocking=True)
        flags_h.copy_(flags, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return errs_h, flags_h, event

    def step(self) -> bool:
        """Pack + dispatch one tile without waiting for its results.

        ``readback="deferred"`` (default): the results of up to
        ``max_inflight`` dispatches stay in flight — no synchronization —
        until `flush` reads them back in one batch.
        ``readback="per_tile"``: depth-2 pipeline, tile ``t`` is read back
        (blocking) once ``t+1`` is in flight.  Returns False when the queue
        had no work.
        """
        tile = self.packer.pack(self.queue)
        if tile is None:
            return False
        self.probe_donation()  # cached after the first call (or warmup())
        self.thresholds  # materialize mus for this version
        errs, flags, event = self._dispatch(tile)
        self.stats["dispatches"] += 1
        self.stats["dispatched_cols"] += int(np.prod(tile.x.shape[::2]))
        self._inflight.append((tile, errs, flags, event))
        # Deferred mode accumulates in-flight results (bounded by
        # max_inflight so queued buffers can't grow without limit); per-tile
        # mode is the depth-2 pipeline (read t back once t+1 is in flight).
        while len(self._inflight) > self.max_inflight:
            self._harvest()
        return True

    def flush(self) -> int:
        """Drain the queue and all in-flight tiles; returns completed
        request count available in ``results``.

        This is where deferred readback synchronizes: every in-flight tile's
        event is awaited, then its host copies harvested — the only wait in
        the deferred hot loop.
        """
        while self.step():
            pass
        for _, _, _, event in self._inflight:
            if event is not None:
                event.synchronize()
        while self._inflight:
            self._harvest()
        return len(self.results)

    def _harvest(self) -> None:
        tile, errs, flags, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        errs = errs.numpy()
        flags = flags.numpy()
        for a in tile.assignments:
            stop = a.start + a.cols.size
            dst = a.sl if a.sl is not None else a.cols
            a.request.scores[dst] = errs[a.slot, a.start:stop]
            a.request.flags[dst] = flags[a.slot, a.start:stop]
            a.request.pending -= int(a.cols.size)
            self.stats["scored"] += int(a.cols.size)
            if self.cache is not None and a.request.hashes is not None:
                hs = a.request.hashes
                run = errs[a.slot, a.start:stop]
                self.cache.put_many(
                    a.request.tenant, self.version,
                    [hs[j] for j in a.cols.tolist()], run.tolist(),
                )
            if a.request.done:
                self._finish(a.request)

    def _finish(self, req: ScoreRequest) -> None:
        # Cache-hit columns never went through the tile's thresholding —
        # flag them here with the same version's mus (NaN compares False).
        mus = self.thresholds
        with np.errstate(invalid="ignore"):
            req.flags = (req.scores > mus[req.tenant]).astype(np.int32)
        self.stats["served"] += req.n_samples
        self.results[req.request_id] = ScoreResult(
            request_id=req.request_id, tenant=req.tenant, scores=req.scores,
            flags=req.flags, cached_cols=req.cached_cols,
        )

    def take(self, request_id: int) -> ScoreResult:
        """Pop a completed request's result (KeyError if not done yet)."""
        return self.results.pop(request_id)

    # ------------------------------------------------------------------
    # Model lifecycle: retrain without a stop-the-world
    # ------------------------------------------------------------------

    def partial_fit(self, x_new) -> fleet.DAEFFleet:
        """Absorb a new data block into the served fleet.

        Flushes in-flight work (scored under the old version), retrains via
        the engine (which bumps the model version, invalidating every cache
        key; B4 on the fused backend), and folds ONLY the new block's train
        errors into the recalibration sketches — the online-threshold path.
        """
        self.flush()
        new_state = self.engine.partial_fit(self.state, x_new)
        self.update_state(new_state)
        return new_state

    def update_state(self, new_state: fleet.DAEFFleet) -> None:
        """Swap in a retrained fleet (e.g. from a `FederationSession`
        round), folding the appended train errors into the sketches.  The
        new leaves are copied into the buffers the captured graphs read, in
        place: the fleet keeps its config, so its leaves keep their shapes."""
        if not isinstance(new_state, fleet.DAEFFleet) or \
                new_state.size != self.state.size:
            raise PlanError(
                f"update_state: expected a {self.state.size}-tenant "
                "DAEFFleet"
            )
        self.flush()
        errors = new_state.model.train_errors.detach().cpu().numpy()
        if errors.shape[-1] > self._train_cols:
            new_block = errors[..., self._train_cols:]
            for t in range(new_state.size):
                self.sketches[t].add(new_block[t])
            self.stats["recalibrations"] += 1
        elif errors.shape[-1] < self._train_cols:
            # Not an append (e.g. a freshly fit fleet): rebuild the sketches.
            self.sketches = [
                ErrorSketch.from_errors(errors[t], bins=self._sketch_bins)
                for t in range(new_state.size)
            ]
            self.stats["recalibrations"] += 1
        self._train_cols = errors.shape[-1]
        self.state = new_state
        weights, biases = self._leaves
        for dst, src in zip(weights + biases, new_state.model.weights + new_state.model.biases,
                            strict=True):
            dst.copy_(src)
        # Engine mutations bump the counter; a state built outside the
        # engine still must invalidate, so the server version is monotone.
        self.version = max(self.engine.model_version, self.version + 1)
        self._mus = None
        if self.cache is not None:
            self.cache.drop_stale(self.version)

    def __repr__(self) -> str:
        return (f"FleetServer(tenants={self.state.size}, "
                f"version={self.version}, pending={len(self.queue)}, "
                f"dispatches={self.stats['dispatches']}, "
                f"cache={self.cache!r})")
