"""Latency/throughput summaries shared by the serve CLI and benchmarks (a
copy of ``repro/serving/metrics.py``).

One definition of "p50"/"p95" — linearly interpolated percentiles (the
``numpy.percentile`` default) — so `launch/serve.py --fleet` prints the same
statistic `benchmarks/serve_latency.py` writes to ``BENCH_serve.json``.
The previous CLI picked ``sorted(lat)[len(lat) // 2]``, which is upper-biased
for even sample counts and disagreed with the benchmark's records.
"""
from __future__ import annotations

import numpy as np


def percentile(values, pct: float) -> float:
    """Linearly interpolated percentile (``pct`` in [0, 100])."""
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        raise ValueError("percentile of an empty sequence")
    return float(np.percentile(vals, pct))


def latency_summary(latencies_s, served: int) -> dict:
    """p50/p95 (ms) + throughput over a list of per-round second latencies.

    ``served`` must count the SAME rounds ``latencies_s`` covers — callers
    exclude the JIT warm-up round from both or neither.
    """
    lat_ms = [x * 1e3 for x in latencies_s]
    total = sum(latencies_s)
    return {
        "rounds": len(lat_ms),
        "p50_ms_per_round": percentile(lat_ms, 50),
        "p95_ms_per_round": percentile(lat_ms, 95),
        "scores_per_sec": served / max(total, 1e-9),
        "served": served,
    }
