"""DAEFEngine — one client-facing API over every DAEF execution path
(counterpart of ``repro/engine/engine.py``).

The engine binds a ``DAEFConfig`` (the math: layer sizes, lambdas, knowledge
representation) to an ``ExecutionPlan`` (the placement: loop / vmap / mesh,
tenant count, merge strategy, stats backend, streaming chunk width) and to
one device, and exposes ONE spelling of

    fit / fit_stream / partial_fit / predict / scores / merge / reduce /
    thresholds / classify / save / load / session

It dispatches to the port's one-tenant core (`core.daef`), its tenant
fleet (`core.fleet`), the tenant-sharded fleet (`core.fleet_sharded`) and
the data-sharded single model (`core.sharded`), resolving the
stats-backend precedence (plan > config > ``$REPRO_STATS_BACKEND`` >
default) and the device exactly once, at construction.  ``device=None`` is
the card (see :mod:`repro_torch.device`; a mesh plan's rank uses
``cuda:{LOCAL_RANK}``); every state the engine returns lives on its device.

Mesh plans (``launch.mesh``): every rank runs the same calls on the same
global inputs.  The mesh is sized as the reference's (an automatic tenant
mesh takes the largest divisor of the fleet that fits the ranks); a mesh
over fewer ranks than the process group is built on every rank at
construction, and the ranks outside it are idle: their calls return None.  A tenant-sharded plan over D ranks returns each rank's
shard, a ``DAEFFleet`` of K/D tenants, and takes either that shard or the
global fleet (which it shards); its scores and predictions are the rank's
tenants'.  A data-sharded plan returns the same weights on every rank and
each rank's samples' train errors and scores; ``thresholds`` gathers the
errors first.  ``save`` gathers to rank 0, which alone writes; ``load``
re-places the state onto the mesh.  With one rank every mesh path is the
reference's one-device mesh.

State convention: with a 3-D ``[K, features, samples]`` batch the engine
works on a ``DAEFFleet``; with a 2-D ``[features, samples]`` matrix on a
single ``DAEFModel``.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from repro_torch.core import anomaly, daef, dsvd, fleet, fleet_sharded, rolann, sharded
from repro_torch.core.federated import _host
from repro_torch.device import as_tensor, resolve_device
from repro_torch.engine.plan import ExecutionPlan, PlanError
from repro_torch.launch import mesh as mesh_lib

EngineState = daef.DAEFModel | fleet.DAEFFleet


def _members_only(method):
    """On an idle rank (outside the plan's mesh) the call does nothing and
    returns None; on every other rank it runs."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if self.idle:
            return None
        return method(self, *args, **kwargs)
    return wrapper


def _bumps_model_version(method):
    """Mark an engine method as producing a NEW model: the engine's
    ``model_version`` counter ticks after it returns (not on error)."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        out = method(self, *args, **kwargs)
        self._model_version += 1
        return out
    return wrapper


class DAEFEngine:
    """Unified DAEF training/serving engine (see module docstring).

    >>> import numpy as np
    >>> from repro_torch.core import daef
    >>> from repro_torch.engine import DAEFEngine, ExecutionPlan
    >>> cfg = daef.DAEFConfig(layer_sizes=(8, 3, 5, 8))
    >>> engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=4), device="cpu")
    >>> xs = np.random.default_rng(0).normal(size=(4, 8, 64)).astype("float32")
    >>> fl = engine.fit(xs)                       # one batched fleet fit
    >>> scores = engine.scores(fl, xs)            # [4, 64] reconstruction MSE
    >>> sites = engine.reduce(fl, group_size=2)   # federate per plan.merge
    >>> sites.size
    2
    """

    def __init__(
        self,
        config: daef.DAEFConfig,
        plan: ExecutionPlan | None = None,
        *,
        mesh=None,
        device=None,
    ):
        """Bind the math to a placement and a device.

        Args:
            config: the DAEF formulation — layer sizes, lambdas, knowledge
                representation (``method``), seed, gram solver.
            plan: the placement/dispatch choice; ``None`` means the default
                ``ExecutionPlan()`` (one model, vmap mode).
            mesh: an explicit ``launch.mesh.Mesh`` for ``mode="mesh"``
                plans.  ``None`` builds and caches one on first use from
                ``plan.mesh_devices``.
            device: where every state lives and every fit runs; ``None`` is
                the card (a mesh's device when a mesh is given).

        Raises:
            PlanError: as the reference's: ``plan`` is not an ExecutionPlan;
                the plan and config conflict; the mesh is missing a required
                axis or does not tile the fleet, or asks for more devices
                than the world has.  A mesh plan with ``mesh_devices`` or
                under a process group of several ranks builds its mesh here
                (a sub-group is a collective: every rank constructs alike).
            RuntimeError: ``device`` is the card and none is present.
        """
        plan = plan if plan is not None else ExecutionPlan()
        if not isinstance(plan, ExecutionPlan):
            raise PlanError(
                f"plan must be an ExecutionPlan, got {type(plan).__name__}"
            )
        # stats-backend precedence, resolved ONCE: plan.stats_backend >
        # config.stats_backend > $REPRO_STATS_BACKEND > default ("auto", for
        # the platform of the engine's device).
        if plan.stats_backend is not None:
            config = dataclasses.replace(config, stats_backend=plan.stats_backend)
        config = config.resolved(mesh.device if mesh is not None and device is None
                                 else device)
        plan = dataclasses.replace(plan, stats_backend=config.stats_backend)
        if plan.chunk_samples is not None and config.method != "gram":
            raise PlanError(
                f"chunk_samples={plan.chunk_samples} streams the fit by "
                "accumulating Gram sufficient statistics chunk by chunk, but "
                f"config.method={config.method!r} — SVD factors have no "
                "additive chunk form; use method='gram'"
            )
        if plan.privacy is not None and plan.privacy.enabled:
            if config.method != "gram":
                raise PlanError(
                    "plan.privacy hardens ADDITIVE (G, M) exchanges, but "
                    f"config.method={config.method!r} — factor knowledge has "
                    "neither a bounded-sensitivity DP release nor an additive "
                    "secagg wire form; use method='gram'"
                )
            if plan.privacy.dp_enabled and (
                config.act_hidden != "logsig" or config.act_last != "linear"
            ):
                raise PlanError(
                    "plan.privacy DP sensitivity bounds are derived for "
                    "act_hidden='logsig' + act_last='linear', got "
                    f"({config.act_hidden!r}, {config.act_last!r}) — "
                    "unbounded activations make the release sensitivity "
                    "unbounded (privacy.dp.block_sensitivities)"
                )
        self.config = config
        self.plan = plan
        self._model_version = 0
        self._mesh = None
        if mesh is not None:
            self._check_mesh(mesh)
            if device is not None and mesh_lib.rank_device(device) != mesh.device:
                raise PlanError(f"the mesh's rank lives on {mesh.device} but "
                                f"device={device!r} was asked for")
            self._mesh = mesh
            self.device = mesh.device
        elif plan.mode == "mesh":
            self.device = mesh_lib.rank_device(device)
            if plan.mesh_devices is not None or mesh_lib.world_size() > 1:
                # build eagerly: surface bad mesh sizes at init, and build a
                # sub-group mesh on every rank at the same call (an idle
                # rank makes no later call that the others would wait on)
                self.mesh
        else:
            self.device = resolve_device(device)

    @property
    def model_version(self) -> int:
        """Monotone counter of model-producing mutations through this
        engine (fit / fit_stream / partial_fit / merge / reduce / session
        rounds).  A serving cache keys on it."""
        return self._model_version

    def _bump_version(self) -> None:
        """Tick ``model_version`` for mutations that bypass the decorated
        engine methods (e.g. `FederationSession.round`)."""
        self._model_version += 1

    # ------------------------------------------------------------------
    # Mesh
    # ------------------------------------------------------------------

    def _check_mesh(self, mesh) -> None:
        if self.plan.mode != "mesh":
            raise PlanError(
                f"an explicit mesh was given but plan.mode={self.plan.mode!r}; "
                "use ExecutionPlan(mode='mesh', ...)"
            )
        missing = [a for a in self.plan.mesh_axes if a not in mesh.shape]
        if missing:
            raise PlanError(
                f"mesh {dict(mesh.shape)} has no axis {missing} required by "
                f"plan.mesh_axes={self.plan.mesh_axes}"
            )
        if self.plan.tenant_sharded:
            d = mesh.shape[fleet_sharded.TENANT_AXIS]
            if self.plan.tenants % d:
                raise PlanError(
                    f"bad mesh size: tenants={self.plan.tenants} does not "
                    f"divide evenly over the {d}-device "
                    f"'{fleet_sharded.TENANT_AXIS}' axis — pad the fleet or "
                    "resize the mesh"
                )

    @property
    def mesh(self):
        """The device mesh this plan runs on (built once, then cached).
        None for loop/vmap plans."""
        if self.plan.mode != "mesh":
            return None
        if self._mesh is None:
            self._mesh = self._build_mesh()
        return self._mesh

    def _build_mesh(self):
        """The reference's sizing over the ranks of the default process
        group (one without a group): an automatic tenant mesh takes the
        largest divisor of the fleet that fits the ranks, ``mesh_devices``
        takes that many.  A mesh of fewer ranks than the world is global
        ranks ``0 .. n-1`` over a sub-group, and the other ranks are idle
        (see :attr:`idle`)."""
        plan = self.plan
        avail = mesh_lib.world_size()
        if plan.tenant_sharded:
            d = plan.mesh_devices
            if d is None:
                d = min(avail, plan.tenants)
                while d > 1 and plan.tenants % d:
                    d -= 1
            if d > avail:
                raise PlanError(
                    f"bad mesh size: mesh_devices={d} exceeds the {avail} "
                    "available device(s) — shrink the plan or run on more "
                    "devices"
                )
            return fleet_sharded.tenant_mesh(d, device=self.device)
        if len(plan.mesh_axes) != 1:
            raise PlanError(
                f"cannot auto-build a mesh for axes {plan.mesh_axes}; pass "
                "mesh= explicitly (e.g. launch.mesh.make_production_mesh())"
            )
        n = plan.mesh_devices or avail
        if n > avail:
            raise PlanError(
                f"bad mesh size: mesh_devices={n} exceeds the {avail} "
                "available device(s)"
            )
        return mesh_lib.Mesh((n,), plan.mesh_axes, device=self.device)

    @property
    def idle(self) -> bool:
        """Whether this rank lies outside the plan's mesh (a mesh over fewer
        ranks than the process group).  An idle rank took part in building
        the mesh and in nothing after: every state-producing call returns
        None there (see `_members_only`)."""
        mesh = self.mesh
        return mesh is not None and not mesh.member

    def _tenant_devices(self) -> int:
        return self.mesh.shape[fleet_sharded.TENANT_AXIS] if self.plan.tenant_sharded else 1

    def _local(self, state):
        """A tenant-sharded plan's state as this rank's shard (a global
        fleet is cut; a shard passes through)."""
        if (isinstance(state, fleet.DAEFFleet) and self._tenant_devices() > 1
                and state.size == self.plan.tenants):
            return fleet_sharded.shard_fleet(state, self.mesh)
        return state

    # ------------------------------------------------------------------
    # Input handling
    # ------------------------------------------------------------------

    def _check_x(self, x, *, what: str) -> bool:
        """Validate a data batch; True when it is a [K, m, n] fleet batch."""
        ndim = getattr(x, "ndim", None)
        m0 = self.config.layer_sizes[0]
        if ndim == 3:
            k = x.shape[0]
            if k != self.plan.tenants:
                raise PlanError(
                    f"{what}: batch has {k} tenants but the plan declares "
                    f"tenants={self.plan.tenants} — reshape the batch or "
                    "re-plan"
                )
            if x.shape[1] != m0:
                raise PlanError(
                    f"{what}: feature dim {x.shape[1]} != layer_sizes[0] {m0}"
                )
            if self.plan.data_sharded:
                raise PlanError(
                    f"{what}: plan shards the sample axis of a single model "
                    f"(mesh_axes={self.plan.mesh_axes}) but got a 3-D tenant "
                    "batch; use mesh_axes=('tenants',) for fleets"
                )
            return True
        if ndim == 2:
            if self.plan.tenants != 1:
                raise PlanError(
                    f"{what}: got a single [features, samples] matrix but the "
                    f"plan declares tenants={self.plan.tenants}; stack the "
                    "per-tenant data to [K, features, samples]"
                )
            if x.shape[0] != m0:
                raise PlanError(
                    f"{what}: feature dim {x.shape[0]} != layer_sizes[0] {m0}"
                )
            return False
        raise PlanError(
            f"{what}: expected [features, samples] or [K, features, samples], "
            f"got shape {getattr(x, 'shape', None)}"
        )

    def _is_fleet(self, state: EngineState, *, what: str) -> bool:
        if isinstance(state, fleet.DAEFFleet):
            d = self._tenant_devices()
            if state.size != self.plan.tenants and not (
                    d > 1 and state.size * d == self.plan.tenants):
                raise PlanError(
                    f"{what}: fleet has {state.size} tenants but the plan "
                    f"declares tenants={self.plan.tenants}"
                )
            return True
        if isinstance(state, daef.DAEFModel):
            if self.plan.tenants != 1:
                raise PlanError(
                    f"{what}: got a single DAEFModel but the plan declares "
                    f"tenants={self.plan.tenants}"
                )
            return False
        raise PlanError(
            f"{what}: expected a DAEFModel or DAEFFleet, got "
            f"{type(state).__name__}"
        )

    # ------------------------------------------------------------------
    # fit / partial_fit
    # ------------------------------------------------------------------

    @_members_only
    @_bumps_model_version
    def fit(
        self,
        x,
        *,
        seeds=None,
        lam_hidden=None,
        lam_last=None,
        n_partitions: int = 1,
    ) -> EngineState:
        """Train under the plan — closed form, no epochs.

        With ``plan.chunk_samples`` set, training streams: every layer's
        statistics accumulate over sample chunks instead of materializing
        the full activations.

        Args:
            x: ``[K, features, samples]`` for a fleet (K == plan.tenants) or
                ``[features, samples]`` for a single model; moved to the
                engine's device.
            seeds, lam_hidden, lam_last: scalar-or-``[K]`` per-tenant
                overrides (fleet batches only).
            n_partitions: split the sample axis to exercise the distributed
                SVD/merge path.

        Returns:
            The fitted ``DAEFModel`` or ``DAEFFleet`` (a tenant-sharded mesh
            plan: this rank's shard).  On an idle rank — outside a mesh over
            fewer ranks than the process group — None, with nothing run.

        Raises:
            PlanError: batch shape disagrees with the plan, per-tenant
                overrides on a single model, or ``n_partitions`` combined
                with ``plan.chunk_samples``.
        """
        cfg, plan, dev = self.config, self.plan, self.device
        chunk = plan.chunk_samples
        if chunk is not None and n_partitions != 1:
            raise PlanError(
                f"fit: n_partitions={n_partitions} simulates explicit "
                "partitions but plan.chunk_samples already streams the "
                "sample axis — drop one of the two"
            )
        if not self._check_x(x, what="fit"):
            if seeds is not None or lam_hidden is not None or lam_last is not None:
                raise PlanError(
                    "fit: per-tenant seeds/lambdas apply to fleet batches; "
                    "for a single model set them on the DAEFConfig"
                )
            if plan.data_sharded:
                return sharded._fit_on_mesh(
                    cfg, x, self.mesh, data_axes=plan.mesh_axes,
                    local_factorization=plan.local_factorization,
                )
            if chunk is not None:
                return daef.fit_chunked(cfg, x, chunk_samples=chunk, device=dev)
            return daef.fit(cfg, x, n_partitions=n_partitions, device=dev)

        if plan.mode == "loop":
            seeds, lam_hidden, lam_last = fleet._prepare_fit(
                cfg, x, seeds, lam_hidden, lam_last, dev
            )
            models = [
                daef.fit_chunked(
                    self._tenant_cfg(seeds, lam_hidden, lam_last, i),
                    x[i], chunk_samples=chunk, device=dev,
                )
                if chunk is not None
                else daef.fit(
                    self._tenant_cfg(seeds, lam_hidden, lam_last, i),
                    x[i], n_partitions=n_partitions, device=dev,
                )
                for i in range(plan.tenants)
            ]
            return fleet.fleet_from_models(
                cfg, models, seeds=seeds, lam_hidden=lam_hidden,
                lam_last=lam_last,
            )
        if plan.mode == "mesh":
            return fleet_sharded._fit_sharded(
                cfg, x, self.mesh, seeds=seeds, lam_hidden=lam_hidden,
                lam_last=lam_last, n_partitions=n_partitions, chunk_samples=chunk,
            )
        if chunk is not None:
            return fleet._fit_fleet_chunked(
                cfg, x, chunk_samples=chunk, seeds=seeds,
                lam_hidden=lam_hidden, lam_last=lam_last, device=dev,
            )
        return fleet._fit_fleet(
            cfg, x, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last,
            n_partitions=n_partitions, device=dev,
        )

    @_members_only
    @_bumps_model_version
    def fit_stream(
        self,
        batches,
        *,
        seeds=None,
        lam_hidden=None,
        lam_last=None,
    ) -> EngineState:
        """Train from a host chunk source — data that never fits on the
        device.

        ``batches`` yields fixed-shape chunks — ``[features, chunk_samples]``
        for a single model, ``[K, features, chunk_samples]`` for a fleet
        (only the final chunk may be narrower; it is padded and masked
        exactly).  Accepts any iterable (snapshotted into a host list of
        chunk references — the fit makes one pass per layer) or a zero-arg
        callable returning a fresh iterator per pass.  Each chunk is
        uploaded to the engine's device on its own.  Matches ``fit`` on the
        concatenated data within accumulation-order float error."""
        cfg, plan, dev = self.config, self.plan, self.device
        if cfg.method != "gram":
            raise PlanError(
                "fit_stream accumulates Gram sufficient statistics; "
                f"config.method={cfg.method!r} has no additive chunk form — "
                "use method='gram'"
            )
        if plan.data_sharded:
            raise PlanError(
                "fit_stream streams host chunks, but the plan shards the "
                f"sample axis on-mesh (mesh_axes={plan.mesh_axes}) — use "
                "mode='vmap'/'loop' or a tenant-sharded mesh plan"
            )
        if plan.tenants == 1:
            if seeds is not None or lam_hidden is not None or lam_last is not None:
                raise PlanError(
                    "fit_stream: per-tenant seeds/lambdas apply to fleet "
                    "streams; for a single model set them on the DAEFConfig"
                )
            return daef.fit_stream(cfg, batches, device=dev)
        if plan.mode == "loop":
            factory = daef._stream_chunk_source(batches)
            seeds, lam_hidden, lam_last = self._prepare_stream_fleet(
                factory, seeds, lam_hidden, lam_last
            )
            if not callable(batches):
                # snapshot sources: convert each chunk to host ONCE and hand
                # every tenant a view — not K device-to-host copies per chunk
                host_chunks = [_host(c) for c in factory()]
                factory = lambda: iter(host_chunks)  # noqa: E731
            models = [
                daef.fit_stream(
                    self._tenant_cfg(seeds, lam_hidden, lam_last, i),
                    lambda i=i: (_host(c)[i] for c in factory()),
                    device=dev,
                )
                for i in range(plan.tenants)
            ]
            return fleet.fleet_from_models(
                cfg, models, seeds=seeds, lam_hidden=lam_hidden,
                lam_last=lam_last,
            )
        if plan.mode == "mesh":
            return fleet_sharded._fit_sharded_stream(
                cfg, batches, self.mesh, seeds=seeds, lam_hidden=lam_hidden,
                lam_last=lam_last, tenants=plan.tenants,
            )
        return fleet._fit_fleet_stream(
            cfg, batches, seeds=seeds, lam_hidden=lam_hidden,
            lam_last=lam_last, tenants=plan.tenants, device=dev,
        )

    def _prepare_stream_fleet(self, factory, seeds, lam_hidden, lam_last):
        """Loop-mode stream helper: peek one chunk to learn K, then broadcast
        the per-tenant hyperparameters exactly as the batched paths do."""
        first = next(iter(factory()), None)
        if first is None:
            raise PlanError("fit_stream: empty chunk stream")
        shape = getattr(first, "shape", None)
        if shape is None or len(shape) != 3 or shape[0] != self.plan.tenants:
            raise PlanError(
                f"fit_stream: fleet chunks must be [K={self.plan.tenants}, "
                f"features, chunk_samples], got {shape}"
            )
        k, dev = shape[0], self.device
        return (
            fleet._per_tenant(seeds, self.config.seed, k, torch.int32, dev),
            fleet._per_tenant(lam_hidden, self.config.lam_hidden, k, torch.float32, dev),
            fleet._per_tenant(lam_last, self.config.lam_last, k, torch.float32, dev),
        )

    @_members_only
    @_bumps_model_version
    def partial_fit(self, state: EngineState, x_new) -> EngineState:
        """Incremental learning: absorb a new data block (per tenant).

        Honors ``plan.chunk_samples``: the update block is fitted by the
        streaming accumulator before the knowledge merge.

        Raises:
            PlanError: ``state`` or ``x_new`` disagrees with the plan.
        """
        cfg, plan, dev = self.config, self.plan, self.device
        chunk = plan.chunk_samples
        if not self._is_fleet(state, what="partial_fit"):
            self._check_x(x_new, what="partial_fit")
            if plan.data_sharded:
                update = sharded._fit_on_mesh(
                    cfg, x_new, self.mesh, data_axes=plan.mesh_axes,
                    local_factorization=plan.local_factorization,
                )
                return daef.merge_models(cfg, state, update)
            if chunk is not None:
                update = daef.fit_chunked(cfg, x_new, chunk_samples=chunk, device=dev)
                return daef.merge_models(cfg, state, update)
            return daef.partial_fit(cfg, state, x_new, device=dev)
        self._check_x(x_new, what="partial_fit")
        if plan.mode == "loop":
            models = []
            for i in range(plan.tenants):
                cfg_i = self._tenant_cfg(
                    state.seeds, state.lam_hidden, state.lam_last, i
                )
                if chunk is not None:
                    update = daef.fit_chunked(cfg_i, x_new[i], chunk_samples=chunk,
                                              device=dev)
                    models.append(
                        daef.merge_models(cfg_i, fleet.get_model(state, i), update)
                    )
                else:
                    models.append(
                        daef.partial_fit(cfg_i, fleet.get_model(state, i), x_new[i],
                                         device=dev)
                    )
            return fleet.fleet_from_models(
                cfg, models, seeds=state.seeds, lam_hidden=state.lam_hidden,
                lam_last=state.lam_last,
            )
        if plan.mode == "mesh":
            return fleet_sharded.sharded_fleet_partial_fit(
                cfg, self._local(state), x_new, mesh=self.mesh, chunk_samples=chunk,
            )
        if chunk is not None:
            update = fleet._fit_fleet_chunked(
                cfg, x_new, chunk_samples=chunk, seeds=state.seeds,
                lam_hidden=state.lam_hidden, lam_last=state.lam_last, device=dev,
            )
        else:
            update = fleet._fit_fleet(
                cfg, x_new, seeds=state.seeds, lam_hidden=state.lam_hidden,
                lam_last=state.lam_last, device=dev,
            )
        return fleet.fleet_merge(cfg, state, update)

    def _tenant_cfg(self, seeds, lam_hidden, lam_last, i: int) -> daef.DAEFConfig:
        return dataclasses.replace(
            self.config,
            seed=int(seeds[i]),
            lam_hidden=float(lam_hidden[i]),
            lam_last=float(lam_last[i]),
        )

    # ------------------------------------------------------------------
    # predict / scores
    # ------------------------------------------------------------------

    @_members_only
    def predict(self, state: EngineState, x) -> torch.Tensor:
        """Reconstruct ``x`` ([K, m, n] per-tenant, or [m, n] single)."""
        cfg, dev, plan = self.config, self.device, self.plan
        if not self._is_fleet(state, what="predict"):
            self._check_x(x, what="predict")
            if plan.data_sharded:
                return sharded.predict_on_mesh(cfg, state, x, self.mesh,
                                               data_axes=plan.mesh_axes)
            return daef.predict(cfg, state, x, device=dev)
        self._check_x(x, what="predict")
        if plan.mode == "mesh":
            return fleet_sharded.sharded_fleet_predict(cfg, self._local(state), x,
                                                       mesh=self.mesh)
        if plan.mode == "loop":
            return torch.stack([
                daef.predict(cfg, fleet.get_model(state, i), x[i], device=dev)
                for i in range(self.plan.tenants)
            ])
        return fleet.fleet_predict(cfg, state, x, device=dev)

    @_members_only
    def scores(self, state: EngineState, x, n_valid=None) -> torch.Tensor:
        """Per-sample anomaly scores (reconstruction MSE): [K, n] or [n].

        ``n_valid`` ([K] ints, fleet only) masks a padded serving batch:
        scores of padding columns come back NaN.  Mesh plans give this
        rank's tenants' (or samples') scores."""
        cfg, dev, plan = self.config, self.device, self.plan
        if not self._is_fleet(state, what="scores"):
            if n_valid is not None:
                raise PlanError(
                    "scores: n_valid masks padded FLEET batches; a single "
                    "model takes an unpadded [features, samples] matrix"
                )
            self._check_x(x, what="scores")
            if plan.data_sharded:
                xp = sharded.shard_samples(x, self.mesh, plan.mesh_axes)
                return torch.mean((daef.predict(cfg, state, xp, device=dev) - xp) ** 2, dim=0)
            return daef.reconstruction_error(cfg, state, x, device=dev)
        self._check_x(x, what="scores")
        if plan.mode == "mesh":
            return fleet_sharded.sharded_fleet_scores(cfg, self._local(state), x,
                                                      n_valid=n_valid, mesh=self.mesh)
        if plan.mode == "loop":
            errs = torch.stack([
                daef.reconstruction_error(cfg, fleet.get_model(state, i), x[i], device=dev)
                for i in range(self.plan.tenants)
            ])
            if n_valid is None:
                return errs
            mask = (torch.arange(x.shape[-1], device=dev)[None, :]
                    < torch.as_tensor(n_valid, device=dev)[:, None])
            return torch.where(mask, errs, torch.nan)
        return fleet.fleet_scores(cfg, state, x, n_valid=n_valid, device=dev)

    @_members_only
    def thresholds(self, state: EngineState, rule: str = "extreme_iqr") -> torch.Tensor:
        """Per-tenant anomaly thresholds from each model's train errors (a
        tenant-sharded plan's: this rank's tenants'; a data-sharded plan
        gathers every rank's errors first)."""
        if self._is_fleet(state, what="thresholds"):
            return fleet.fleet_thresholds(self._local(state), rule=rule)
        errors = state.train_errors
        if self.plan.data_sharded:
            errors = sharded.gather_samples(errors, self.mesh, self.plan.mesh_axes)
        return anomaly.threshold(errors, rule, device=self.device)

    def classify(self, scores, thresholds) -> torch.Tensor:
        """Flag anomalies (1 = anomalous); NaN padding scores classify 0."""
        scores = as_tensor(scores, self.device)
        if scores.ndim == 2:
            return fleet.fleet_classify(scores, thresholds, device=self.device)
        return anomaly.classify(scores, thresholds, device=self.device)

    # ------------------------------------------------------------------
    # Federation: merge / reduce / session
    # ------------------------------------------------------------------

    @_members_only
    @_bumps_model_version
    def merge(self, a: EngineState, b: EngineState) -> EngineState:
        """Federated aggregation of two states trained with shared seeds
        (tenant k of ``a`` merges with tenant k of ``b``): statistics added
        (Eq. 6-9), one re-solve.

        Raises:
            PlanError: mixed state kinds, or a fleet whose size disagrees
                with the plan.
            ValueError: fleets with different per-tenant seeds or lambdas.
        """
        a_fleet = self._is_fleet(a, what="merge")
        b_fleet = self._is_fleet(b, what="merge")
        if a_fleet != b_fleet:
            raise PlanError(
                "merge: cannot mix a DAEFModel with a DAEFFleet — wrap the "
                "single model in a 1-tenant fleet (fleet.fleet_from_models) "
                "or extract the tenant (engine.get_model)"
            )
        if not a_fleet:
            return daef.merge_models(self.config, a, b)
        a, b = self._local(a), self._local(b)
        if self.plan.mode == "loop":
            fleet._check_merge_compat(a, b, "merge")
            models = [
                daef.merge_models(
                    self._tenant_cfg(a.seeds, a.lam_hidden, a.lam_last, i),
                    fleet.get_model(a, i), fleet.get_model(b, i),
                )
                for i in range(self.plan.tenants)
            ]
            return fleet.fleet_from_models(
                self.config, models, seeds=a.seeds, lam_hidden=a.lam_hidden,
                lam_last=a.lam_last,
            )
        return fleet.fleet_merge(self.config, a, b)

    @_members_only
    @_bumps_model_version
    def reduce(self, state: fleet.DAEFFleet, group_size: int) -> fleet.DAEFFleet:
        """Federate adjacent groups of ``group_size`` tenants into one model
        each (K -> K/group_size), using the plan's ``merge`` strategy:

        * "sequential" — left-to-right ``daef.merge_models`` reduce;
        * "pairwise"   — log2(group_size) rounds of batched pairwise merges;
        * "tree"       — the butterfly of `fleet_sharded.fleet_merge_tree`
                         (over the plan's mesh for tenant-sharded plans).

        Tenants within a group must share a seed (the paper's
        shared-randomness requirement).  A tenant-sharded plan over several
        ranks gathers the fleet for "sequential" and "pairwise" (every rank
        returns the whole result); "tree" returns what `fleet_merge_tree`
        does.  On an idle rank (outside a mesh over fewer ranks than the
        process group) it returns None, with nothing run.

        Raises:
            PlanError: a single model, a group size that does not divide the
                fleet, or a non-power-of-two group under "pairwise"/"tree".
            ValueError: unequal seeds or lambdas within a group.
        """
        if not self._is_fleet(state, what="reduce"):
            raise PlanError("reduce: a single model has nothing to reduce")
        k, merge = self.plan.tenants, self.plan.merge  # the global fleet size
        if group_size < 1 or k % group_size:
            raise PlanError(
                f"reduce: group_size {group_size} must divide the fleet "
                f"size {k}"
            )
        if merge in ("pairwise", "tree") and (group_size & (group_size - 1)):
            raise PlanError(
                f"reduce: merge={merge!r} needs a power-of-two group_size "
                f"(got {group_size}) — use merge='sequential' for arbitrary "
                "group sizes"
            )
        if group_size == 1:
            return state
        if merge == "tree":
            return fleet_sharded.fleet_merge_tree(
                self.config, self._local(state), group_size,
                mesh=self.mesh if self.plan.tenant_sharded else None,
            )
        if self._tenant_devices() > 1:
            state = fleet_sharded.gather_fleet(self._local(state), self.mesh)
        fleet._validate_groups(state, group_size)
        if merge == "pairwise":
            while group_size > 1:
                state = fleet.fleet_merge_pairwise(self.config, state)
                group_size //= 2
            return state
        # sequential: exact left-to-right reduction per group
        models = []
        for g in range(k // group_size):
            cfg_g = self._tenant_cfg(
                state.seeds, state.lam_hidden, state.lam_last, g * group_size
            )
            merged = fleet.get_model(state, g * group_size)
            for j in range(1, group_size):
                merged = daef.merge_models(
                    cfg_g, merged, fleet.get_model(state, g * group_size + j)
                )
            models.append(merged)
        stride = slice(None, None, group_size)
        return fleet.fleet_from_models(
            self.config, models, seeds=state.seeds[stride],
            lam_hidden=state.lam_hidden[stride],
            lam_last=state.lam_last[stride],
        )

    def for_tenants(self, tenants: int) -> DAEFEngine:
        """A derived engine for a different fleet size — same config, same
        mode/merge/backend, same device.  The natural follow-up to
        ``reduce``: the K/group_size result fleet is served by
        ``engine.for_tenants(K // group_size)``."""
        plan = self.plan
        mesh_devices = plan.mesh_devices
        if mesh_devices is not None and tenants % mesh_devices:
            mesh_devices = None
        return DAEFEngine(
            self.config,
            dataclasses.replace(plan, tenants=tenants, mesh_devices=mesh_devices),
            device=self.device,
        )

    def _writes(self) -> bool:
        """Whether this rank writes checkpoints: rank 0 of a mesh, or any
        rank of a plan without one."""
        return self.mesh is None or self.mesh.rank == 0

    def session(self) -> FederationSession:  # noqa: F821 (imported lazily)
        """A multi-round federation driver bound to this engine.

        ``plan.federation`` selects the round semantics — "sync" lockstep
        rounds or "async" continual rounds with a versioned per-site ledger
        and ``plan.max_staleness`` bounds."""
        from repro_torch.engine.session import FederationSession

        return FederationSession(self)

    # ------------------------------------------------------------------
    # save / load
    # ------------------------------------------------------------------

    @_members_only
    def save(self, state, path: str) -> str:
        """Persist a trained state (msgpack-framed numpy, via
        ``train.checkpoint``, the reference's layout) or a mid-federation
        ``FederationSession`` (see ``FederationSession.save``).  Returns the
        checkpoint directory.  A mesh plan gathers the state to rank 0, which
        alone writes; every rank returns once it has."""
        from repro_torch.engine.session import FederationSession
        from repro_torch.train import checkpoint

        if isinstance(state, FederationSession):
            out = state.save(path) if self._writes() else path
        else:
            if self._is_fleet(state, what="save"):
                if self._tenant_devices() > 1 and state.size != self.plan.tenants:
                    state = fleet_sharded.gather_fleet(state, self.mesh)
            elif self.plan.data_sharded:
                state = state._replace(train_errors=sharded.gather_samples(
                    state.train_errors, self.mesh, self.plan.mesh_axes))
            out = checkpoint.save(path, state) if self._writes() else path
        if self.mesh is not None:
            self.mesh.barrier()
        return out

    @_members_only
    def load(self, path: str):
        """Restore whatever ``save`` (of either package) wrote at ``path``
        under a structurally identical config/plan: a ``session.json`` in
        the directory means a ``FederationSession`` (rebound to THIS
        engine), anything else a model/fleet state, on the engine's
        device; mesh plans re-place the state onto the mesh (a fleet's
        shard, a data-sharded model's train errors of this rank's
        samples)."""
        from repro_torch.train import checkpoint

        if os.path.exists(os.path.join(path, "session.json")):
            from repro_torch.engine.session import FederationSession

            return FederationSession.restore(self, path)
        try:
            state = checkpoint.restore(path, self._template())
        except ValueError as e:
            raise PlanError(
                f"load: checkpoint at {path!r} does not match this engine's "
                f"config/plan ({e}); load with the engine that saved it"
            ) from e
        state = self._to_device(state)
        if isinstance(state, fleet.DAEFFleet) and self.plan.tenant_sharded:
            return fleet_sharded.shard_fleet(state, self.mesh)
        if isinstance(state, daef.DAEFModel) and self.plan.data_sharded:
            lo, hi = sharded._shard_bounds(state.train_errors.shape[-1], self.mesh,
                                           self.plan.mesh_axes)
            return state._replace(train_errors=state.train_errors[lo:hi])
        return state

    def _to_device(self, tree):
        """A restored tree's numpy leaves as tensors on the engine's device."""
        from repro_torch.train import checkpoint

        return checkpoint.map_leaves(
            lambda a: torch.from_numpy(np.array(a)).to(self.device), tree
        )

    def _template(self) -> EngineState:
        """Structural skeleton matching what fit() returns — checkpoint
        restore only consults the tree structure; shapes come from the
        manifest."""
        model = _model_template(self.config)
        if self.plan.tenants == 1:
            return model
        z = np.zeros((0,), np.float32)
        return fleet.DAEFFleet(model=model, seeds=z, lam_hidden=z, lam_last=z)

    # ------------------------------------------------------------------

    def get_model(self, state: EngineState, i: int = 0) -> daef.DAEFModel:
        """Extract tenant ``i`` as a plain single-model DAEFModel."""
        if self._is_fleet(state, what="get_model"):
            return fleet.get_model(state, i)
        return state

    def __repr__(self) -> str:
        return (
            f"DAEFEngine(layers={self.config.layer_sizes}, "
            f"method={self.config.method!r}, "
            f"stats_backend={self.config.stats_backend!r}, plan={self.plan}, "
            f"device={self.device})"
        )


def _knowledge_template(config: daef.DAEFConfig):
    z = np.zeros((0,), np.float32)
    if config.method == "gram":
        return rolann.RolannStats(g=z, m=z)
    return rolann.RolannFactors(u=z, s=z, m=z)


def _model_template(config: daef.DAEFConfig) -> daef.DAEFModel:
    """A ``DAEFModel`` of empty leaves with ``config``'s structure."""
    n_layers = len(config.layer_sizes)
    z = np.zeros((0,), np.float32)
    know = _knowledge_template(config)
    return daef.DAEFModel(
        weights=tuple(z for _ in range(n_layers - 1)),
        biases=tuple(z for _ in range(n_layers - 2)),
        encoder_factors=dsvd.SvdFactors(u=z, s=z),
        layer_knowledge=tuple(know for _ in range(n_layers - 2)),
        train_errors=z,
    )
