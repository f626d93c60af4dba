"""Online threshold recalibration: additive train-error quantile sketches
(a copy of ``repro/serving/recalibration.py`` on the port's
``core.anomaly``).

The serving layer needs per-tenant anomaly thresholds (quantiles of the
TRAINING reconstruction errors, `core.anomaly.threshold`) that survive
incremental retraining without a stop-the-world pass over every error the
tenant ever produced.  The trick is the same one the paper plays with the
(G, M) training statistics: keep a representation that is *additive* —

    sketch(errors_a ++ errors_b) == fold(sketch(errors_a), sketch(errors_b))

— so when a fleet absorbs a new data block (``partial_fit`` / a
`FederationSession` round), only the NEW block's errors are folded in, and
the threshold re-derives from the running sketch in O(bins).

The sketch is a fixed-width histogram with power-of-two range doubling:

* ``add`` widens the range by doubling the bin width (anchored at the
  existing ``lo`` or ``hi`` edge), which coarsens the counts by pairing
  adjacent bins — an EXACT fold, no resolution lost beyond the wider bins;
* ``merge`` of two sketches on aligned grids is an exact count sum; on
  misaligned grids old counts re-bin by bin center (error bounded by one
  bin width — see `tests/test_serving.py` for the tolerance this holds to);
* quantiles invert the interpolated CDF, clamped to the exact observed
  ``vmin``/``vmax``, so with B bins the quantile error is O(range / B).

NaNs (the padding sentinel of masked score buffers) are dropped on entry —
a sketch never poisons a threshold the way a plain ``quantile`` over a
padded buffer does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import anomaly

DEFAULT_BINS = 1024


@dataclasses.dataclass
class ErrorSketch:
    """Additive quantile sketch over a stream of reconstruction errors."""

    bins: int = DEFAULT_BINS
    lo: float = 0.0          # left edge of bin 0
    width: float = 0.0       # bin width (0.0 = empty sketch, no grid yet)
    counts: np.ndarray | None = None   # [bins] float64
    n: int = 0               # total folded samples (NaNs excluded)
    vmin: float = np.inf     # exact observed extremes
    vmax: float = -np.inf

    def __post_init__(self):
        if self.bins < 2:
            raise ValueError(f"need at least 2 bins, got {self.bins}")
        if self.counts is None:
            self.counts = np.zeros(self.bins, np.float64)

    # ------------------------------------------------------------------
    # Folding
    # ------------------------------------------------------------------

    @classmethod
    def from_errors(cls, errors, bins: int = DEFAULT_BINS) -> "ErrorSketch":
        sk = cls(bins=bins)
        sk.add(errors)
        return sk

    def add(self, errors) -> "ErrorSketch":
        """Fold a batch of errors into the sketch (NaNs dropped)."""
        vals = np.asarray(errors, np.float64).ravel()
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            return self
        lo, hi = float(vals.min()), float(vals.max())
        self.vmin = min(self.vmin, lo)
        self.vmax = max(self.vmax, hi)
        if self.width == 0.0:
            # First data: pick a grid spanning the batch (degenerate
            # constant batches get a unit-width grid around the value).
            span = hi - lo
            self.lo = lo
            self.width = (span / self.bins) if span > 0 else 1.0 / self.bins
        self._cover(lo, hi)
        idx = np.floor((vals - self.lo) / self.width).astype(np.int64)
        np.clip(idx, 0, self.bins - 1, out=idx)
        np.add.at(self.counts, idx, 1.0)
        self.n += int(vals.size)
        return self

    def _cover(self, lo: float, hi: float) -> None:
        """Grow the grid (exactly, by doubling) until [lo, hi] fits."""
        # Widen to the right first (anchored at self.lo): pairs of old bins
        # collapse into one new bin — an exact re-bin.
        while hi >= self.lo + self.bins * self.width:
            half = self.counts[0::2] + self.counts[1::2]
            self.counts[: self.bins // 2] = half
            self.counts[self.bins // 2:] = 0.0
            self.width *= 2.0
        # Then to the left (anchored at the top edge).
        while lo < self.lo:
            top = self.lo + self.bins * self.width
            half = self.counts[0::2] + self.counts[1::2]
            self.counts[self.bins // 2:] = half
            self.counts[: self.bins // 2] = 0.0
            self.width *= 2.0
            self.lo = top - self.bins * self.width

    def merge(self, other: "ErrorSketch") -> "ErrorSketch":
        """Fold another sketch in (the (G, M)-style additive combine).

        Exact when the grids align (same ``lo``/``width`` after coverage
        growth); otherwise the other sketch's counts re-bin by bin center,
        bounded by one bin width of error.
        """
        if other.n == 0:
            return self
        if self.width == 0.0:
            self.lo, self.width = other.lo, other.width
            self.counts = other.counts.copy()
            self.n = other.n
            self.vmin, self.vmax = other.vmin, other.vmax
            return self
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self._cover(other.lo, other.lo + other.bins * other.width)
        aligned = (
            other.width == self.width
            and abs((other.lo - self.lo) / self.width
                    - round((other.lo - self.lo) / self.width)) < 1e-9
        )
        if aligned and other.bins == self.bins:
            off = round((other.lo - self.lo) / self.width)
            hi = min(self.bins, off + other.bins)
            self.counts[off:hi] += other.counts[: hi - off]
        else:
            centers = other.lo + (np.arange(other.bins) + 0.5) * other.width
            idx = np.floor((centers - self.lo) / self.width).astype(np.int64)
            np.clip(idx, 0, self.bins - 1, out=idx)
            np.add.at(self.counts, idx, other.counts)
        self.n += other.n
        return self

    # ------------------------------------------------------------------
    # Quantiles / thresholds
    # ------------------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Invert the interpolated CDF at ``q`` in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.n == 0:
            return float("nan")
        target = q * self.n
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, side="left"))
        b = min(b, self.bins - 1)
        prev = cum[b - 1] if b else 0.0
        in_bin = self.counts[b]
        frac = (target - prev) / in_bin if in_bin > 0 else 0.0
        val = self.lo + (b + frac) * self.width
        return float(min(max(val, self.vmin), self.vmax))

    def threshold(self, rule: str = "extreme_iqr") -> float:
        """`core.anomaly.threshold` over the sketched distribution — same
        rule grammar ("q<percent>" / "unusual_iqr" / "extreme_iqr")."""
        pct = anomaly.parse_quantile_rule(rule)
        if pct is not None:
            return self.quantile(pct / 100.0)
        q1, q3 = self.quantile(0.25), self.quantile(0.75)
        iqr = q3 - q1
        if rule == "unusual_iqr":
            return q3 + 1.5 * iqr
        if rule == "extreme_iqr":
            return q3 + 3.0 * iqr
        raise ValueError(f"unknown threshold rule {rule!r}")

    def __repr__(self) -> str:
        return (f"ErrorSketch(n={self.n}, bins={self.bins}, "
                f"range=[{self.vmin:.4g}, {self.vmax:.4g}])")
