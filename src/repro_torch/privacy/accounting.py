"""Per-site (epsilon, delta) accounting across federation rounds.

A copy of ``repro/privacy/accounting.py`` (plain floats): a session saved by
either package restores its spend history in the other.

Every DP release a site makes (`privacy.dp.fit_dp` → one published
exchange state) spends one ``(epsilon, delta)`` entry here.  The ledger
answers "what has this site spent IN TOTAL" under two composition
theorems and refuses releases that would exceed a declared budget:

* **basic** — (sum of epsilons, sum of deltas).  Tight for one release,
  linear growth over rounds.
* **advanced** — the heterogeneous advanced composition bound (Dwork,
  Rothblum & Vadhan 2010; Kairouz et al. 2015 form): for releases
  ``(eps_i, delta_i)`` and a slack ``delta'``,

      eps_total = sqrt(2 ln(1/delta') * sum eps_i^2)
                  + sum eps_i (e^{eps_i} - 1)
      delta_total = sum delta_i + delta'

  Sub-linear in the round count for small per-round epsilons — the
  right regime for continual federation.

The ledger is plain host state (floats), serializable via
``spends()``/``from_spends`` so a mid-session `FederationSession`
checkpoint restores accounting exactly.
"""
from __future__ import annotations

import math

#: Slack delta' consumed by the advanced composition bound (added to the
#: reported delta total; not spent by any individual release).
ADVANCED_SLACK = 1e-9


class PrivacyBudgetExceeded(RuntimeError):
    """A release would push a site past its privacy budget."""


class PrivacyLedger:
    """Cumulative (epsilon, delta) ledger for ONE site (see module doc).

    >>> ledger = PrivacyLedger(budget_epsilon=10.0, composition="basic")
    >>> ledger.spend(4.0, 1e-5)
    >>> ledger.spent()
    (4.0, 1e-05)
    >>> ledger.spend(4.0, 1e-5)
    >>> ledger.spend(4.0, 1e-5)           # doctest: +IGNORE_EXCEPTION_DETAIL
    Traceback (most recent call last):
    PrivacyBudgetExceeded: ...
    """

    def __init__(
        self,
        *,
        budget_epsilon: float | None = None,
        budget_delta: float | None = None,
        composition: str = "advanced",
        slack: float = ADVANCED_SLACK,
    ):
        if composition not in ("basic", "advanced"):
            raise ValueError(
                f"unknown composition {composition!r}: choose 'basic' or "
                "'advanced'"
            )
        self.budget_epsilon = budget_epsilon
        self.budget_delta = budget_delta
        self.composition = composition
        self.slack = slack
        self._spends: list[tuple[float, float]] = []

    # ------------------------------------------------------------------

    def spent(self) -> tuple[float, float]:
        """Total (epsilon, delta) under the ledger's composition mode."""
        return self._compose(self._spends)

    def _compose(self, spends: list[tuple[float, float]]) -> tuple[float, float]:
        if not spends:
            return 0.0, 0.0
        if self.composition == "basic":
            return (sum(e for e, _ in spends), sum(d for _, d in spends))
        sum_sq = sum(e * e for e, _ in spends)
        linear = sum(e * (math.exp(e) - 1.0) for e, _ in spends)
        eps = math.sqrt(2.0 * math.log(1.0 / self.slack) * sum_sq) + linear
        delta = sum(d for _, d in spends) + self.slack
        # Basic composition is also always valid — report the tighter bound
        # (advanced only wins once the release count amortizes the slack).
        basic_eps = sum(e for e, _ in spends)
        if basic_eps <= eps:
            return basic_eps, sum(d for _, d in spends)
        return eps, delta

    def check(self, epsilon: float, delta: float) -> None:
        """Raise `PrivacyBudgetExceeded` if spending (epsilon, delta) NOW
        would exceed the budget.  Does not record anything."""
        eps_after, delta_after = self._compose(
            self._spends + [(float(epsilon), float(delta))]
        )
        if self.budget_epsilon is not None and eps_after > self.budget_epsilon:
            raise PrivacyBudgetExceeded(
                f"release of (epsilon={epsilon}, delta={delta}) would bring "
                f"this site's total to epsilon={eps_after:.4g} under "
                f"{self.composition} composition, over the budget_epsilon="
                f"{self.budget_epsilon} after {len(self._spends)} release(s) "
                "— stop reporting this site, raise the budget, or lower the "
                "per-round epsilon"
            )
        if self.budget_delta is not None and delta_after > self.budget_delta:
            raise PrivacyBudgetExceeded(
                f"release of (epsilon={epsilon}, delta={delta}) would bring "
                f"this site's total to delta={delta_after:.4g}, over the "
                f"budget_delta={self.budget_delta} after "
                f"{len(self._spends)} release(s) — stop reporting this site, "
                "raise the budget, or lower the per-round delta"
            )

    def spend(self, epsilon: float, delta: float) -> None:
        """Record one release, refusing it first if it would exceed the
        budget (the ledger is checked BEFORE any statistics leave the
        site — a refused release spends nothing)."""
        self.check(epsilon, delta)
        self._spends.append((float(epsilon), float(delta)))

    # ------------------------------------------------------------------
    # Introspection / serialization
    # ------------------------------------------------------------------

    @property
    def releases(self) -> int:
        """Number of recorded releases."""
        return len(self._spends)

    def spends(self) -> list[tuple[float, float]]:
        """The raw (epsilon, delta) spend log (a copy)."""
        return list(self._spends)

    @classmethod
    def from_spends(
        cls,
        spends,
        *,
        budget_epsilon: float | None = None,
        budget_delta: float | None = None,
        composition: str = "advanced",
        slack: float = ADVANCED_SLACK,
    ) -> "PrivacyLedger":
        """Rebuild a ledger from a serialized spend log (checkpoint restore;
        the log is trusted — budgets are only enforced on NEW spends)."""
        ledger = cls(budget_epsilon=budget_epsilon, budget_delta=budget_delta,
                     composition=composition, slack=slack)
        ledger._spends = [(float(e), float(d)) for e, d in spends]
        return ledger

    def __repr__(self) -> str:
        eps, delta = self.spent()
        return (f"PrivacyLedger(releases={self.releases}, "
                f"spent=(eps={eps:.4g}, delta={delta:.4g}), "
                f"composition={self.composition!r}, "
                f"budget_epsilon={self.budget_epsilon})")
