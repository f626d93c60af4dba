"""Privacy tier for the federated exchange (counterpart of ``repro.privacy``).

Selected via ``ExecutionPlan(privacy=PrivacySpec(...))``:

* `PrivacySpec`     — declarative spec (DP epsilon/delta/clip, budgets,
                      secure aggregation, fixed-point precision);
* `dp.fit_dp`       — Gaussian-mechanism release of every exchanged
                      statistics block (the private `daef.fit`), its noise
                      the reference's bits under the same key;
* `PrivacyLedger`   — per-site cumulative (epsilon, delta) accounting
                      with budget refusal (`PrivacyBudgetExceeded`);
* `secagg`          — pairwise-masked aggregation: the broker sees only
                      the round aggregate, bit-exactly;
* `threat`          — the honest-but-curious adversary model and the
                      reconstruction demo that motivates the tier.
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
