"""FederationSession — the multi-round federation driver of the engine API
(counterpart of ``repro/engine/session.py``).

The paper's §4.3 scenario as a session object: every round, a set of nodes
contributes a private partition; the session aggregates their mergeable
sufficient statistics into ONE logical model and carries it across rounds.
Two round semantics exist, selected by the plan's ``federation`` field:

**Sync (default, lockstep)** — ``round(parts)`` assumes every participating
site reports before any merge; round r+1 merges into the accumulated model
(``daef.merge_models``).  The aggregation strategy comes from the plan's
``merge`` field:

* ``merge="sequential"`` — the EXACT layer-synchronized protocol
  (``federated._federated_fit``): nodes aggregate the encoder first, then
  proceed layer by layer, each time pooling the ROLANN knowledge before
  solving.  Works for ragged partitions.  On the fused backend every site's
  every hidden layer is one launch of the B1 kernel.
* ``merge="pairwise"`` — broker protocol: each node trains a full local
  DAEF, then the models reduce in pairwise rounds (an odd tail passes
  through).
* ``merge="tree"`` — the butterfly: the round's partitions fit as one
  stacked fleet (each rank its share, under a tenant-sharded plan whose
  ranks tile the round) and reduce by ``fleet_sharded.fleet_merge_tree``
  with one re-solve at the root.

**Async (``ExecutionPlan(federation="async")``, continual)** — any subset
of sites may report per round (``round({site: x, ...})``); the session
keeps a versioned per-site contribution ledger — each site's accumulated
exchange state plus the refresh-clock value of its last report — and every
round REBUILDS the live model from whichever sites are within
``plan.max_staleness`` refreshes of the clock, with one weight re-solve.
Stale sites drop out and re-enter with their full accumulated contribution
the moment they report again (delta replay).  Equal-width rounds under a
``vmap`` plan fit as one fleet (the B4 kernel on the fused backend).

Under ``merge="tree"`` the async refresh reduces the fresh sites' states,
masked and padded to a power of two, by ``fleet_sharded.merge_state_tree``,
and a secagg round sums its wires by ``fleet_sharded.merge_wire_tree``.

Exchange states live on the engine's device, except each site's per-sample
train-error pool, which the session keeps on the host, as the reference
does; pooled errors go to the device once, for the re-solve.  Secure
aggregation (``PrivacySpec(secagg=True)``) masks the additive wire form of
each state (`privacy.secagg`); a DP spec (``PrivacySpec(epsilon=...)``)
releases every site's state through `privacy.dp.fit_dp`, keyed per (site,
round, occurrence) and spent on the site's `PrivacyLedger` first.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import daef, dsvd, federated, fleet, fleet_sharded, threefry
from repro_torch.device import as_tensor
from repro_torch.engine.engine import _knowledge_template, _model_template
from repro_torch.engine.plan import PlanError
from repro_torch.privacy.accounting import PrivacyLedger

# A site's exchange state: (encoder SvdFactors padded to rank m0, per-layer
# ROLANN knowledge, host-side per-sample train-error pool).
ExchangeState = tuple

# Ledger key of the one cumulative masked aggregate under async secagg: the
# broker never sees per-site states, so the ledger cannot key on site ids.
SECAGG_AGGREGATE = "secagg:aggregate"

_SESSION_META = "session.json"
_SESSION_ARRAYS = "arrays"


@dataclasses.dataclass
class _SiteRecord:
    """One async ledger entry: a site's accumulated contribution + version.

    ``state`` folds every block the site ever reported (additive statistics,
    so the fold is exact); ``version`` is the refresh-clock value at the
    site's last report — staleness = clock - version.
    """

    state: ExchangeState
    version: int
    submits: int = 1


class FederationSession:
    """Round-based federation bound to a DAEFEngine (see module docstring).

    Sync (lockstep) rounds — every site reports, merged per ``plan.merge``:

    >>> session = engine.session()
    >>> model = session.round(parts)        # parts: per-node [m0, n_p]
    >>> model = session.round(new_parts)    # merged into the running model

    Async (continual) rounds — any subset reports, keyed by site id;
    requires ``ExecutionPlan(federation="async")``:

    >>> model = session.round({"a": xa, "b": xb})   # both sites fresh
    >>> model = session.round({"a": xa2})           # "b" now staleness 1
    >>> model = session.round({})                   # refresh only
    """

    def __init__(self, engine):
        self.engine = engine
        self.model: daef.DAEFModel | None = None
        self.rounds_run = 0
        self.clock = 0
        self._ledger: dict = {}
        # site id -> PrivacyLedger (cumulative DP spend; survives reset()).
        self._privacy_ledgers: dict = {}

    # ------------------------------------------------------------------
    # Rounds
    # ------------------------------------------------------------------

    def round(self, parts) -> daef.DAEFModel | None:
        """Run one federation round and return the live global model.

        Args:
            parts: the round's per-site partitions, each ``[features m0,
                samples]`` (moved to the engine's device).  A sequence
                (sites implicitly numbered 0..n-1), a sequence of
                ``(site, partition)`` pairs, or a mapping of site id ->
                partition (async sites keep their ledger identity across
                rounds by id).

        Returns:
            The accumulated global ``DAEFModel``.  Sync: the running merge
            of every round so far.  Async: the model rebuilt from all
            fresh sites' accumulated contributions — ``None`` only when no
            site has ever reported.

        Raises:
            PlanError: empty ``parts`` in sync mode, a partition with the
                wrong shape, or a round incompatible with the plan's
                ``merge`` strategy.
        """
        named = self._check_parts(parts)
        if self.engine.plan.async_federation:
            model = self._round_async(named)
            # A round produces a (possibly) new live model: tick the
            # engine's model_version so serving caches invalidate.
            self.engine._bump_version()
            return model
        if not named:
            raise PlanError(
                "round: need at least one partition (sync rounds are "
                "lockstep; use ExecutionPlan(federation='async') for "
                "refresh-only rounds)"
            )
        update = (
            self._aggregate_round_private(named) if self._privacy is not None
            else self._aggregate_round([p for _, p in named])
        )
        self.model = (
            update if self.model is None
            else daef.merge_models(self.engine.config, self.model, update)
        )
        self.rounds_run += 1
        self.engine._bump_version()
        return self.model

    @staticmethod
    def _is_pair_sequence(items: list) -> bool:
        """Whether every element reads as an explicit ``(site, part)`` pair
        (site ids are int or str — the same ids a mapping would carry)."""
        return bool(items) and all(
            isinstance(e, (tuple, list)) and len(e) == 2
            and isinstance(e[0], (int, str)) and not isinstance(e[0], bool)
            for e in items
        )

    def _check_parts(self, parts) -> list[tuple]:
        """Normalize parts to [(site, [m0, n] tensor on the engine's
        device), ...], validated.  A repeated site id within one round FOLDS
        under async semantics and raises under sync lockstep."""
        dev = self.engine.device
        if isinstance(parts, Mapping):
            named = [(site, as_tensor(p, dev)) for site, p in parts.items()]
        elif isinstance(parts, Sequence) or hasattr(parts, "__iter__"):
            items = list(parts)
            if self._is_pair_sequence(items):
                named = [(site, as_tensor(p, dev)) for site, p in items]
            else:
                named = [(i, as_tensor(p, dev)) for i, p in enumerate(items)]
        else:
            raise PlanError(
                f"round: parts must be a sequence of partitions, a sequence "
                f"of (site, partition) pairs, or a site -> partition "
                f"mapping, got {type(parts).__name__}"
            )
        m0 = self.engine.config.layer_sizes[0]
        for site, p in named:
            if p.ndim != 2 or p.shape[0] != m0:
                raise PlanError(
                    f"round: partition {site!r} must be [features={m0}, "
                    f"samples], got shape {tuple(p.shape)}"
                )
        sites = [s for s, _ in named]
        if len(set(sites)) != len(sites):
            dups = sorted({repr(s) for s in sites if sites.count(s) > 1})
            if not self.engine.plan.async_federation:
                raise PlanError(
                    f"round: site(s) {', '.join(dups)} report twice in one "
                    "lockstep round — sync rounds have no per-site ledger "
                    "to fold repeats into; concatenate the partitions "
                    "client-side or use federation='async' (repeats fold "
                    "into the site's accumulated state)"
                )
            if self._privacy is not None and self._privacy.secagg:
                raise PlanError(
                    f"round: site(s) {', '.join(dups)} report twice in one "
                    "secagg round — duplicated ids unbalance the pairwise "
                    "masks (cancellation needs exactly one wire per "
                    "participant); concatenate the partitions client-side"
                )
        return named

    # ------------------------------------------------------------------
    # Privacy tier (plan.privacy)
    # ------------------------------------------------------------------

    @property
    def _privacy(self):
        """The active PrivacySpec, or None when the tier is off.  A
        constructed-but-disabled spec returns None too, so every disabled
        path is bit-exact with the plain session by construction."""
        spec = self.engine.plan.privacy
        return spec if spec is not None and spec.enabled else None

    def _ledger_for(self, site) -> PrivacyLedger:
        led = self._privacy_ledgers.get(site)
        if led is None:
            spec = self.engine.plan.privacy
            led = PrivacyLedger(
                budget_epsilon=spec.budget_epsilon,
                budget_delta=spec.budget_delta,
                composition=spec.composition,
            )
            self._privacy_ledgers[site] = led
        return led

    def privacy_spent(self, site) -> tuple[float, float]:
        """Cumulative ``(epsilon, delta)`` spent by ``site`` across every
        round so far, under the spec's composition rule.  (0.0, 0.0) for a
        site that never released."""
        led = self._privacy_ledgers.get(site)
        return (0.0, 0.0) if led is None else led.spent()

    def _dp_key(self, site, occurrence: int = 0) -> torch.Tensor:
        """Per-(site, round, occurrence) release key: fold the site's id,
        the round tick and the within-round occurrence index into the
        config seed, so no two releases EVER reuse noise (an async site
        may legally report twice in one round) and reruns are
        reproducible.  The reference's key bit for bit (`threefry.fold_in`
        is ``jax.random.fold_in``)."""
        cfg = self.engine.config
        root = threefry.PRNGKey(cfg.seed)
        site_key = threefry.fold_in(
            root, zlib.crc32(repr(site).encode()) & 0x7FFFFFFF
        )
        tick = (self.clock if self.engine.plan.async_federation
                else self.rounds_run)
        return threefry.fold_in(threefry.fold_in(site_key, tick), occurrence)

    def _secagg_round(self, sites: list, states: list[ExchangeState]):
        """Masked aggregation of one round: each site's exchange state goes
        to the additive wire form, is fixed-point encoded, masked against
        every other participant, and only the SUM is ever decoded — the
        broker never sees an individual state (mask cancellation is exact
        in uint64, so the aggregate is bit-identical to the unmasked sum)."""
        from repro_torch.privacy import secagg

        cfg, plan = self.engine.config, self.engine.plan
        spec = self._privacy
        salt = self.clock if plan.async_federation else self.rounds_run
        secret = f"daef-secagg:{cfg.seed}"
        wires = [
            secagg.encode(federated.exchange_to_additive(cfg, st),
                          spec.frac_bits)
            for st in states
        ]
        masked = [
            secagg.mask_wire(w, site, sites, secret, salt)
            for site, w in zip(sites, wires, strict=True)
        ]
        if plan.merge == "tree":
            agg = fleet_sharded.merge_wire_tree(masked)
        else:
            agg = secagg.aggregate(masked, plan.merge)
        leaves = secagg.decode(agg, spec.frac_bits,
                               dtypes=[np.float64] * len(agg))
        enc, knw, errors = federated.additive_to_exchange(cfg, leaves,
                                                          device=self.engine.device)
        return enc, knw, np.asarray(errors)

    def _aggregate_round_private(self, named: list[tuple]) -> daef.DAEFModel:
        """One sync lockstep round under the privacy tier: per-site release
        (DP and/or masked wires), reduce, ONE weight re-solve from the
        aggregated knowledge."""
        states = self._local_states(named)
        if self._privacy.secagg:
            enc, knw, errors = self._secagg_round([s for s, _ in named], states)
        elif len(states) == 1:
            enc, knw, errors = states[0]
        else:
            enc, knw, errors = self._reduce_states(states)
        return self._solve(enc, knw, errors)

    def _solve(self, enc, knw, errors) -> daef.DAEFModel:
        """One weight re-solve from exchanged knowledge; the host error pool
        goes to the engine's device."""
        cfg = self.engine.config
        return daef._model_from_knowledge(
            cfg, enc, knw, cfg.layer_keys(), cfg.lam_hidden, cfg.lam_last,
            as_tensor(errors, self.engine.device),
        )

    # ------------------------------------------------------------------
    # Sync aggregation (lockstep)
    # ------------------------------------------------------------------

    def _aggregate_round(self, parts: list[torch.Tensor]) -> daef.DAEFModel:
        cfg, merge = self.engine.config, self.engine.plan.merge
        dev = self.engine.device
        if merge == "sequential":
            return federated._federated_fit(cfg, parts, device=dev)
        if len(parts) == 1:
            return daef.fit(cfg, parts[0], device=dev)
        if merge == "pairwise":
            models = [daef.fit(cfg, p, device=dev) for p in parts]
            while len(models) > 1:
                nxt = [
                    daef.merge_models(cfg, models[i], models[i + 1])
                    for i in range(0, len(models) - 1, 2)
                ]
                if len(models) % 2:
                    nxt.append(models[-1])
                models = nxt
            return models[0]
        # merge == "tree": one stacked fleet fit + the butterfly.
        p = len(parts)
        if p & (p - 1):
            raise PlanError(
                f"round: merge='tree' needs a power-of-two node count, got "
                f"{p} partitions — pad the round, use merge='pairwise', or "
                "go through federation='async' (its masked tree pads "
                "non-power-of-two rounds automatically)"
            )
        lens = {part.shape[1] for part in parts}
        if len(lens) > 1:
            raise PlanError(
                "round: merge='tree' stacks partitions into one fleet batch "
                f"and needs equal sample counts, got {sorted(lens)} — pad "
                "the partitions or use merge='sequential'/'pairwise'"
            )
        xs = torch.stack(parts)
        mesh = self._tree_mesh(p)
        if mesh is None:
            fl = fleet._fit_fleet(cfg, xs, seeds=None, lam_hidden=None,
                                  lam_last=None, device=dev)
        else:  # each rank fits its share of the round
            fl = fleet_sharded._fit_sharded(cfg, xs, mesh)
        merged = fleet_sharded.fleet_merge_tree(cfg, fl, p, mesh=mesh)
        return fleet.get_model(merged, 0)

    def _tree_mesh(self, slots: int):
        """The plan's tenant mesh when its ranks tile ``slots``, else None
        (this rank alone)."""
        engine = self.engine
        mesh = engine.mesh if engine.plan.tenant_sharded else None
        if mesh is not None and slots % mesh.shape[fleet_sharded.TENANT_AXIS]:
            return None  # the round does not tile the plan's fleet mesh
        return mesh

    # ------------------------------------------------------------------
    # Async: versioned ledger + continual refresh
    # ------------------------------------------------------------------

    def _round_async(self, named: list[tuple]) -> daef.DAEFModel | None:
        self.clock += 1
        spec = self._privacy
        if named:
            states = self._local_states(named)
            if spec is not None and spec.secagg:
                # The broker only ever sees the round's masked aggregate:
                # ONE cumulative ledger entry, never per-site states.
                agg = self._secagg_round([s for s, _ in named], states)
                rec = self._ledger.get(SECAGG_AGGREGATE)
                if rec is None:
                    self._ledger[SECAGG_AGGREGATE] = _SiteRecord(agg, self.clock)
                else:
                    rec.state = self._fold(rec.state, agg)
                    rec.version = self.clock
                    rec.submits += 1
            else:
                for (site, _), state in zip(named, states, strict=True):
                    rec = self._ledger.get(site)
                    if rec is None:
                        self._ledger[site] = _SiteRecord(state, self.clock)
                    else:
                        rec.state = self._fold(rec.state, state)
                        rec.version = self.clock
                        rec.submits += 1
        model = self._refresh()
        if model is not None:
            self.model = model
        self.rounds_run += 1
        return self.model

    def _local_states(self, named: list[tuple]) -> list[ExchangeState]:
        """Fit the round's local models and publish their exchange states.

        Equal-width rounds batch into ONE fleet fit under vmap plans (the
        B4 kernel on the fused backend); ragged rounds (and loop plans, the
        parity baseline) fit per site (B1).  All sites share the config's
        seed — the paper's shared stage-1 randomness that makes knowledge
        mergeable.

        Under a DP spec every site's release goes through ``dp.fit_dp``
        instead (the B3 kernel per hidden layer on the fused backend):
        budget check + ledger spend FIRST (an over-budget site aborts the
        round before any noise draw), then the calibrated Gaussian-mechanism
        release keyed per (site, round)."""
        cfg, plan, dev = self.engine.config, self.engine.plan, self.engine.device
        spec = self._privacy
        m0 = cfg.layer_sizes[0]

        def publish(m):
            return (
                dsvd.pad_rank(m.encoder_factors, m0),
                m.layer_knowledge,
                m.train_errors.detach().cpu().numpy(),
            )

        if spec is not None and spec.dp_enabled:
            from repro_torch.privacy import dp

            states, seen = [], {}
            for site, p in named:
                occ = seen.get(site, 0)
                seen[site] = occ + 1
                self._ledger_for(site).spend(spec.epsilon, spec.delta)
                model = dp.fit_dp(cfg, p, self._dp_key(site, occ), spec,
                                  chunk_samples=plan.chunk_samples, device=dev)
                states.append(publish(model))
            return states
        parts = [p for _, p in named]
        widths = {p.shape[1] for p in parts}
        if plan.mode != "loop" and len(parts) > 1 and len(widths) == 1:
            fl = fleet._fit_fleet(cfg, torch.stack(parts), seeds=None,
                                  lam_hidden=None, lam_last=None, device=dev)
            models = [fleet.get_model(fl, i) for i in range(len(parts))]
        else:
            models = [daef.fit(cfg, p, device=dev) for p in parts]
        return [publish(m) for m in models]

    def _fold(self, acc: ExchangeState, new: ExchangeState) -> ExchangeState:
        """Fold a site's new block into its accumulated contribution —
        the delta-replay store: a rejoining site re-enters with everything
        it ever reported, in one state."""
        empty = np.zeros(0, np.float32)
        enc, knw, _ = federated.merge_exchange_states(
            self.engine.config,
            [(acc[0], acc[1], empty), (new[0], new[1], empty)],
        )
        return enc, knw, np.concatenate([acc[2], new[2]])

    def _refresh(self) -> daef.DAEFModel | None:
        """Rebuild the live model from every fresh site's accumulated state
        (one weight re-solve).  No fresh sites -> keep the previous model."""
        plan = self.engine.plan
        fresh = [
            rec.state for rec in self._ledger.values()
            if self.clock - rec.version <= plan.max_staleness
        ]
        if not fresh:
            return None
        return self._solve(*self._reduce_states(fresh))

    def _reduce_states(self, states: list[ExchangeState]):
        """Reduce fresh exchange states per ``plan.merge``: sequential or
        pairwise (`federated.merge_exchange_states`), or the masked
        butterfly (`fleet_sharded.merge_state_tree`)."""
        cfg, merge = self.engine.config, self.engine.plan.merge
        if merge == "tree" and len(states) > 1:
            if cfg.method != "gram":
                raise PlanError(
                    "round: federation='async' with merge='tree' needs "
                    "method='gram' (the masked on-mesh reduction stacks "
                    "fixed-shape states; svd factors are rank-ragged) — "
                    "use merge='sequential'/'pairwise' for method='svd'"
                )
            n = len(states)
            s_padded = 1 << (n - 1).bit_length()
            padded = [(st[0], st[1]) for st in states] + [(states[0][0], states[0][1])] * (s_padded - n)
            stacked = [torch.stack(leaves) for leaves in
                       zip(*(fleet._tree_leaves(st) for st in padded), strict=True)]
            enc, knw = fleet_sharded._rebuild(padded[0], stacked)
            mask = np.zeros(s_padded, np.float32)
            mask[:n] = 1.0
            enc_m, knw_m = fleet_sharded.merge_state_tree(
                cfg, enc, knw, mask, mesh=self._tree_mesh(s_padded))
            return enc_m, knw_m, np.concatenate([st[2] for st in states])
        if merge == "pairwise" and len(states) > 1:
            while len(states) > 1:
                nxt = [
                    federated.merge_exchange_states(cfg, states[i:i + 2])
                    for i in range(0, len(states) - 1, 2)
                ]
                if len(states) % 2:
                    nxt.append(states[-1])
                states = nxt
            return states[0]
        return federated.merge_exchange_states(cfg, states)

    # ------------------------------------------------------------------
    # Persistence (a session survives an engine restart)
    # ------------------------------------------------------------------

    @staticmethod
    def _site_meta(site) -> list:
        if isinstance(site, bool) or not isinstance(site, (int, str)):
            raise PlanError(
                f"session save: site ids must be int or str to persist "
                f"across restarts, got {type(site).__name__} ({site!r})"
            )
        return ["int", int(site)] if isinstance(site, int) else ["str", site]

    @staticmethod
    def _site_from_meta(meta: list):
        kind, value = meta
        return int(value) if kind == "int" else str(value)

    def save(self, path: str) -> str:
        """Persist the full session mid-federation: the live model, every
        site's accumulated exchange state + version + submit count, the
        round clock, and each site's privacy-ledger spend history.  Layout
        (the reference's): ``path/session.json`` (metadata) +
        ``path/arrays`` (a train.checkpoint of the array tree).  Returns
        ``path``."""
        from repro_torch.train import checkpoint

        sites = list(self._ledger.items())
        meta = {
            "clock": self.clock,
            "rounds_run": self.rounds_run,
            "has_model": self.model is not None,
            "sites": [
                {"id": self._site_meta(site), "version": rec.version,
                 "submits": rec.submits}
                for site, rec in sites
            ],
            "privacy": [
                [self._site_meta(site), led.spends()]
                for site, led in self._privacy_ledgers.items()
            ],
        }
        tree = {
            "model": self.model if self.model is not None else (),
            "sites": [rec.state for _, rec in sites],
        }
        os.makedirs(path, exist_ok=True)
        checkpoint.save(os.path.join(path, _SESSION_ARRAYS), tree)
        tmp = os.path.join(path, _SESSION_META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(path, _SESSION_META))
        return path

    @classmethod
    def restore(cls, engine, path: str) -> FederationSession:
        """Rebuild a session saved by ``save`` (of either package) under a
        structurally identical engine.  The model and the exchange
        statistics go to the engine's device; the error pools stay on the
        host.  ``DAEFEngine.load`` dispatches here when the checkpoint
        directory carries ``session.json``."""
        from repro_torch.train import checkpoint

        with open(os.path.join(path, _SESSION_META)) as f:
            meta = json.load(f)
        cfg = engine.config
        n_layers = len(cfg.layer_sizes)
        z = np.zeros((0,), np.float32)
        know = _knowledge_template(cfg)
        state_t = (
            dsvd.SvdFactors(u=z, s=z),
            tuple(know for _ in range(n_layers - 2)),
            z,
        )
        template = {
            "model": _model_template(cfg) if meta["has_model"] else (),
            "sites": [state_t for _ in meta["sites"]],
        }
        try:
            tree = checkpoint.restore(
                os.path.join(path, _SESSION_ARRAYS), template
            )
        except ValueError as e:
            raise PlanError(
                f"session restore: checkpoint at {path!r} does not match "
                f"this engine's config ({e}); restore with an engine "
                "structurally identical to the one that saved it"
            ) from e
        session = cls(engine)
        session.clock = int(meta["clock"])
        session.rounds_run = int(meta["rounds_run"])
        if meta["has_model"]:
            session.model = engine._to_device(tree["model"])
        for site_meta, (enc, knw, errors) in zip(meta["sites"], tree["sites"],
                                                 strict=True):
            state = (engine._to_device(enc), engine._to_device(knw), errors)
            session._ledger[cls._site_from_meta(site_meta["id"])] = (
                _SiteRecord(state, int(site_meta["version"]),
                            int(site_meta["submits"]))
            )
        spec = engine.plan.privacy
        for site_meta, spends in meta.get("privacy", []):
            session._privacy_ledgers[cls._site_from_meta(site_meta)] = (
                PrivacyLedger.from_spends(
                    [tuple(s) for s in spends],
                    budget_epsilon=spec.budget_epsilon if spec else None,
                    budget_delta=spec.budget_delta if spec else None,
                    composition=spec.composition if spec else "advanced",
                )
            )
        return session

    # ------------------------------------------------------------------
    # Site lifecycle / introspection
    # ------------------------------------------------------------------

    @property
    def sites(self) -> dict:
        """Site id -> current staleness (async ledger view; {} for sync)."""
        return {site: self.clock - rec.version
                for site, rec in self._ledger.items()}

    def staleness(self, site) -> int:
        """Refresh rounds since ``site`` last reported (0 = reported in the
        most recent round).  Raises ``KeyError`` for a site never seen."""
        return self.clock - self._ledger[site].version

    def is_fresh(self, site) -> bool:
        """Whether ``site`` currently contributes to the live model."""
        return self.staleness(site) <= self.engine.plan.max_staleness

    def reset(self) -> None:
        """Forget the accumulated model, ledger and clock (fresh federation).

        Privacy ledgers are deliberately KEPT: (epsilon, delta) spend is a
        property of the sites' data, not of the session state."""
        self.model = None
        self.rounds_run = 0
        self.clock = 0
        self._ledger = {}

    def __repr__(self) -> str:
        return (f"FederationSession(rounds_run={self.rounds_run}, "
                f"federation={self.engine.plan.federation!r}, "
                f"merge={self.engine.plan.merge!r}, "
                f"sites={len(self._ledger)}, "
                f"trained={self.model is not None})")
