"""PrivacySpec — the declarative "how private is the exchange" record.

A copy of ``repro/privacy/spec.py`` (numpy-free, no jax): a spec means the
same in both packages, and the port runs both tiers, the DP release
(``privacy.dp``) and secure aggregation (``privacy.secagg``).

The paper's federation exchanges per-layer sufficient statistics (G, M)
and encoder factors.  Those statistics are NOT private by themselves
(docs/privacy.md shows a working single-sample reconstruction from the
encoder Gram); this spec selects the hardening tier applied at the
exchange boundary of a ``FederationSession``:

* ``epsilon``/``delta``/``clip`` — per-site, per-round differential
  privacy: each site clips its sample columns to L2 norm ``clip``,
  trains through the DP release pipeline (`privacy.dp.fit_dp`: every
  released statistics block is perturbed ONCE, at release time, with
  Gaussian noise calibrated by the analytic Gaussian mechanism), and
  publishes only the noised state.  ``epsilon=None`` disables DP.
* ``budget_epsilon``/``budget_delta`` — lifetime per-site budget tracked
  by a `privacy.accounting.PrivacyLedger` under ``composition``
  ("basic" or "advanced"); a release that would exceed it raises
  `PrivacyBudgetExceeded` BEFORE any statistics leave the site.
* ``secagg`` — pairwise-masked secure aggregation: sites publish
  fixed-point-encoded states blinded by antisymmetric pairwise masks, so
  the broker only ever observes the round aggregate
  (`privacy.secagg`).  Composes with DP (mask the noised state).
* ``frac_bits`` — secagg fixed-point precision (fractional bits of the
  int64 wire encoding).

A constructed-but-disabled spec (``PrivacySpec()``) is the identity:
every engine/session path is bit-exact with ``privacy=None`` (pinned by
tests/test_privacy.py and tests/test_torch_privacy.py).
"""
from __future__ import annotations

import dataclasses

COMPOSITIONS = ("basic", "advanced")


class PrivacyError(ValueError):
    """A PrivacySpec that cannot run — message names the fix."""


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """Privacy tier of the federated exchange (see module docstring).
    Frozen and hashable, so it can ride an ExecutionPlan into cache keys."""

    epsilon: float | None = None
    delta: float = 1e-5
    clip: float = 1.0
    secagg: bool = False
    budget_epsilon: float | None = None
    budget_delta: float | None = None
    composition: str = "advanced"
    frac_bits: int = 20

    def __post_init__(self):
        if self.epsilon is not None and not self.epsilon > 0:
            raise PrivacyError(
                f"epsilon must be > 0 (or None to disable DP), got "
                f"{self.epsilon!r}"
            )
        if not 0.0 < self.delta < 1.0:
            raise PrivacyError(
                f"delta must be in (0, 1), got {self.delta!r}"
            )
        if not self.clip > 0:
            raise PrivacyError(
                f"clip must be a positive L2 bound on sample columns, got "
                f"{self.clip!r}"
            )
        if self.composition not in COMPOSITIONS:
            raise PrivacyError(
                f"unknown composition {self.composition!r}: choose from "
                f"{COMPOSITIONS}"
            )
        for name in ("budget_epsilon", "budget_delta"):
            v = getattr(self, name)
            if v is not None and not v > 0:
                raise PrivacyError(
                    f"{name} must be > 0 (or None for an unlimited budget), "
                    f"got {v!r}"
                )
        if (self.budget_epsilon is not None or self.budget_delta is not None) \
                and self.epsilon is None:
            raise PrivacyError(
                "a privacy budget needs a per-release epsilon — set "
                "PrivacySpec(epsilon=...) or drop the budget"
            )
        if not isinstance(self.frac_bits, int) or not 1 <= self.frac_bits <= 40:
            raise PrivacyError(
                f"frac_bits must be an int in [1, 40] (secagg fixed-point "
                f"fractional bits), got {self.frac_bits!r}"
            )

    @property
    def dp_enabled(self) -> bool:
        """Whether DP release is active (``epsilon`` set)."""
        return self.epsilon is not None

    @property
    def enabled(self) -> bool:
        """Whether ANY hardening is active; False means the spec is the
        identity and every path must match ``privacy=None`` bit-exactly."""
        return self.dp_enabled or self.secagg
