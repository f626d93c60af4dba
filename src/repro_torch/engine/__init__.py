"""repro_torch.engine — ONE client-facing API for the port's DAEF paths
(counterpart of ``repro.engine``):

    from repro_torch.engine import DAEFEngine, ExecutionPlan

    engine = DAEFEngine(config, ExecutionPlan(mode="vmap", tenants=64,
                                              stats_backend="fused"))
    fl      = engine.fit(xs)                    # [K, features, samples]
    scores  = engine.scores(fl, batch, n_valid=counts)
    sites   = engine.reduce(fl, group_size=2)   # federation, per plan.merge
    session = engine.session()                  # round-based federation
    model   = session.round(parts)

``device=`` is taken once, by the engine (``None``: the card); every state
it returns lives there.  Every mode runs — ``loop``, ``vmap`` and ``mesh``
(tenant- or data-sharded over the ranks of a ``launch.mesh.Mesh``) — with
every merge, ``"tree"`` included, and either privacy tier (DP release,
secure aggregation).
The module-level ``fleet.fleet_fit`` and ``federated.federated_fit`` are
deprecation shims over this API.
"""
from repro_torch.engine import deprecation  # noqa: F401
from repro_torch.engine.engine import DAEFEngine, EngineState  # noqa: F401
from repro_torch.engine.plan import ExecutionPlan, PlanError  # noqa: F401
from repro_torch.engine.session import FederationSession  # noqa: F401

__all__ = [
    "DAEFEngine",
    "EngineState",
    "ExecutionPlan",
    "FederationSession",
    "PlanError",
]
