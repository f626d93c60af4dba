"""ExecutionPlan — the declarative "where and how does this DAEF run" record.

Counterpart of ``repro/engine/plan.py``: the same fields, defaults and
validation, so that a plan means the same in both packages.  A plan is
data: the engine (``engine.py``) maps ``mode="mesh"`` onto the ranks of a
``launch.mesh.Mesh``.

The paper's selling point is that ONE closed-form formulation covers local,
distributed and incremental training; the repo's kernels mirror that (vmap
fleet, tenant-mesh sharding, data-mesh federation, tree-reduce aggregation),
but each used to carry its own call surface.  An ``ExecutionPlan`` collapses
the choice into configuration:

    plan = ExecutionPlan(mode="mesh", tenants=64, mesh_devices=8,
                         stats_backend="fused", merge="tree")
    engine = DAEFEngine(config, plan)

* ``mode``      — "loop" (eager per-model calls, the debugging/parity
                  baseline), "vmap" (one batched call over the tenant axis:
                  the port's ``_batched`` fleet kernels; the reference's
                  single jitted vmap dispatch) or "mesh" (same kernels with
                  placement: the tenant
                  axis sharded over devices, or — for a single model — the
                  SAMPLE axis sharded over data axes, every shard a
                  federated node).
* ``tenants``   — K, the number of independent per-tenant models (1 = the
                  paper's single autoencoder).
* ``mesh_axes`` — which named mesh axes carry the work in mesh mode:
                  ``("tenants",)`` (default) shards the tenant axis;
                  anything else (e.g. ``("data",)``) is the single-model
                  data-parallel federation of `core.sharded.fit_on_mesh`.
* ``mesh_devices`` — devices along the tenant axis (None = the largest
                  fleet-compatible mesh over all devices).
* ``stats_backend`` — Gram-stats producer ("einsum" | "fused" | "auto"; in
                  the port "auto" resolves to "einsum" until a measured
                  choice exists, ``core/stats_backend.py``);
                  overrides ``DAEFConfig.stats_backend``; None defers to the
                  config / ``$REPRO_STATS_BACKEND`` precedence chain
                  (default "auto").
* ``merge``     — federation reduce strategy for ``DAEFEngine.reduce`` and
                  ``FederationSession.round``: "sequential" (left-to-right
                  host reduce / the exact layer-synchronized protocol),
                  "pairwise" (log2 rounds of vmapped pairwise merges) or
                  "tree" (the on-mesh shard_map butterfly of
                  `fleet_merge_tree`).
* ``local_factorization`` — data-mesh mode only: how each shard factorizes
                  its local Gram ("gram_eigh" | "direct_svd").
* ``chunk_samples`` — streaming training: ``fit``/``partial_fit`` accumulate
                  the per-layer Gram statistics over sample chunks of this
                  width (one ``lax.scan`` pass per layer) instead of
                  materializing every [m_l, n] activation, so peak training
                  memory is O(m^2 + chunk_samples) per tenant — flat in n.
                  Requires the gram knowledge representation
                  (``DAEFConfig.method="gram"``); the result matches the
                  one-shot fit within accumulation-order float error.  Also
                  the default chunk width expected by
                  ``DAEFEngine.fit_stream`` (host-iterator streaming for data
                  that never fits on device at once).
* ``federation`` — round semantics of ``FederationSession``: "sync"
                  (default — lockstep rounds: every participating site
                  reports before any merge) or "async" (continual,
                  barrier-free: any subset of sites may report per round; the
                  session keeps a versioned per-site contribution ledger and
                  refreshes the running global model from whichever sites are
                  within the staleness bound — see docs/federation.md).
* ``max_staleness`` — async federation only: how many refresh rounds a
                  site's last report may lag before the site is EXCLUDED
                  from the live model (it rejoins, with its full accumulated
                  contribution, the next time it reports).  0 = only sites
                  that reported in the current round count.

* ``privacy``    — the exchange-hardening tier (`repro_torch.privacy.PrivacySpec`):
                  per-site DP release of every exchanged statistics block
                  (``epsilon``/``delta``/``clip``, budget-tracked by a
                  per-site ledger) and/or pairwise-masked secure
                  aggregation (``secagg=True``: the broker only ever sees
                  the round aggregate).  ``None`` — and a constructed but
                  disabled spec — leave every path bit-exact with today's
                  behavior.  See docs/privacy.md.

Every future scenario (multi-host fleets, caching) is a new field here —
not a sixth parallel module-level API.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import stats_backend as stats_backend_mod
from repro_torch.privacy.spec import PrivacySpec

MODES = ("loop", "vmap", "mesh")
MERGES = ("sequential", "pairwise", "tree")
FEDERATIONS = ("sync", "async")
TENANT_AXES = ("tenants",)


class PlanError(ValueError):
    """An ExecutionPlan that cannot run — message names the fix."""


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Declarative placement/dispatch choice for a DAEFEngine (see module
    docstring for field semantics).  Frozen and hashable, so a resolved plan
    can key caches the same way a resolved DAEFConfig keys jit caches."""

    mode: str = "vmap"
    tenants: int = 1
    mesh_devices: int | None = None
    mesh_axes: tuple[str, ...] = TENANT_AXES
    stats_backend: str | None = None
    merge: str = "sequential"
    local_factorization: str = "gram_eigh"
    chunk_samples: int | None = None
    federation: str = "sync"
    max_staleness: int = 0
    privacy: PrivacySpec | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise PlanError(
                f"unknown ExecutionPlan mode {self.mode!r}: choose from {MODES}"
            )
        if self.merge not in MERGES:
            raise PlanError(
                f"unknown ExecutionPlan merge {self.merge!r}: choose from "
                f"{MERGES}"
            )
        if self.federation not in FEDERATIONS:
            raise PlanError(
                f"unknown ExecutionPlan federation {self.federation!r}: "
                f"choose from {FEDERATIONS}"
            )
        if not isinstance(self.max_staleness, int) or self.max_staleness < 0:
            raise PlanError(
                f"max_staleness must be a non-negative int (refresh rounds a "
                f"site may lag), got {self.max_staleness!r}"
            )
        if self.max_staleness and self.federation != "async":
            raise PlanError(
                f"max_staleness={self.max_staleness} only applies to "
                "federation='async' (sync rounds are lockstep; every site "
                "reports before any merge) — set federation='async' or drop "
                "the bound"
            )
        if not isinstance(self.tenants, int) or self.tenants < 1:
            raise PlanError(f"tenants must be a positive int, got {self.tenants!r}")
        axes = self.mesh_axes
        if isinstance(axes, str):
            axes = (axes,)
        object.__setattr__(self, "mesh_axes", tuple(axes))
        if not self.mesh_axes or not all(
            isinstance(a, str) and a for a in self.mesh_axes
        ):
            raise PlanError(
                f"mesh_axes must name at least one mesh axis, got {self.mesh_axes!r}"
            )
        if self.mesh_devices is not None:
            if self.mode != "mesh":
                raise PlanError(
                    f"mesh_devices={self.mesh_devices} only applies to "
                    f"mode='mesh' (got mode={self.mode!r}); drop it or switch "
                    "the mode"
                )
            if self.mesh_devices < 1:
                raise PlanError(
                    f"mesh_devices must be >= 1, got {self.mesh_devices}"
                )
            if self.tenant_sharded and self.tenants % self.mesh_devices:
                raise PlanError(
                    f"bad mesh size: tenants={self.tenants} does not divide "
                    f"evenly over mesh_devices={self.mesh_devices} — pad the "
                    "fleet, or resize the mesh to a divisor of the tenant "
                    "count"
                )
        if self.local_factorization not in ("gram_eigh", "direct_svd",
                                            "local_svd"):
            raise PlanError(
                "local_factorization must be 'gram_eigh', 'direct_svd' or "
                f"'local_svd', got {self.local_factorization!r}"
            )
        if self.mode == "mesh" and not self.tenant_sharded and self.tenants > 1:
            raise PlanError(
                f"mesh_axes={self.mesh_axes} shards the sample axis of a "
                f"SINGLE model, but tenants={self.tenants}; use "
                "mesh_axes=('tenants',) for a sharded fleet, or tenants=1 "
                "for data-parallel federation"
            )
        if self.chunk_samples is not None:
            if not isinstance(self.chunk_samples, int) or self.chunk_samples < 1:
                raise PlanError(
                    f"chunk_samples must be a positive int, got "
                    f"{self.chunk_samples!r}"
                )
            if self.mode == "mesh" and not self.tenant_sharded:
                raise PlanError(
                    "chunk_samples streams the SAMPLE axis chunk by chunk, "
                    f"but mesh_axes={self.mesh_axes} already shards the "
                    "sample axis of a single model across devices — drop "
                    "chunk_samples, or use mesh_axes=('tenants',) / "
                    "mode='vmap' for a streamed fit"
                )
        if self.stats_backend is not None:
            # raises on unknown names (same contract as DAEFConfig)
            stats_backend_mod.resolve(self.stats_backend)
        if self.privacy is not None:
            if not isinstance(self.privacy, PrivacySpec):
                raise PlanError(
                    f"privacy must be a PrivacySpec (or None), got "
                    f"{type(self.privacy).__name__}"
                )
            if (self.privacy.enabled and self.federation == "sync"
                    and self.merge == "sequential"):
                raise PlanError(
                    "privacy hardening cannot run under the sync "
                    "merge='sequential' protocol — it synchronizes sites "
                    "layer by layer on raw statistics, so there is no "
                    "site-local release boundary to harden; use "
                    "merge='pairwise'/'tree' or federation='async'"
                )
            if self.privacy.secagg and self.async_federation \
                    and self.max_staleness:
                raise PlanError(
                    f"max_staleness={self.max_staleness} with secagg=True "
                    "is contradictory: masked aggregation hides individual "
                    "site contributions from the broker, so stale sites "
                    "cannot be excluded from the live model — set "
                    "max_staleness=0 (full cumulative aggregate) or drop "
                    "secagg"
                )

    @property
    def tenant_sharded(self) -> bool:
        """mesh mode that shards the TENANT axis (vs the sample axis)."""
        return self.mode == "mesh" and self.mesh_axes == TENANT_AXES

    @property
    def data_sharded(self) -> bool:
        """mesh mode that shards the SAMPLE axis of one model over data axes."""
        return self.mode == "mesh" and not self.tenant_sharded

    @property
    def async_federation(self) -> bool:
        """Continual (barrier-free) FederationSession round semantics."""
        return self.federation == "async"
