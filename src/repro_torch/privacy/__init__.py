"""Privacy tier for the federated exchange (counterpart of ``repro.privacy``).

Selected via ``ExecutionPlan(privacy=PrivacySpec(...))``:

* `PrivacySpec`     — declarative spec (DP epsilon/delta/clip, budgets,
                      secure aggregation, fixed-point precision);
* `PrivacyLedger`   — per-site cumulative (epsilon, delta) accounting
                      with budget refusal (`PrivacyBudgetExceeded`);
* `secagg`          — pairwise-masked aggregation: the broker sees only
                      the round aggregate, bit-exactly.

The reference's ``dp`` (the Gaussian-mechanism release, ``dp.fit_dp``) and
``threat`` (the reconstruction demo) are not ported yet: they are ROADMAP
queue A item 11.  An engine whose plan enables DP raises
``NotImplementedError`` naming that item.
"""
from repro_torch.privacy import secagg  # noqa: F401
from repro_torch.privacy.accounting import PrivacyBudgetExceeded, PrivacyLedger
from repro_torch.privacy.spec import PrivacyError, PrivacySpec

__all__ = [
    "PrivacyBudgetExceeded",
    "PrivacyError",
    "PrivacyLedger",
    "PrivacySpec",
]
