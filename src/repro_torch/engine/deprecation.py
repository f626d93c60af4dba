"""Single-shot DeprecationWarnings for the pre-engine entry points
(counterpart of ``repro/engine/deprecation.py``).

The module-level fit spellings (`fleet.fleet_fit`, `federated.federated_fit`)
are kept as thin shims over `repro_torch.engine` — behaviorally identical,
but each warns exactly once per process so migrating callers see one line,
not one per dispatch.
"""
from __future__ import annotations

import warnings

_WARNED: set[str] = set()


def warn_once(old: str, new: str) -> None:
    """Emit a single DeprecationWarning for ``old`` per process."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated: construct a repro_torch.engine.DAEFEngine and "
        f"use {new} instead (placement is an ExecutionPlan field, not a module "
        "choice)",
        DeprecationWarning,
        stacklevel=3,
    )
