"""Anomaly detection on top of reconstruction errors (paper §6).

Counterpart of ``repro/core/anomaly.py``.  A sample is anomalous iff its
reconstruction MSE exceeds a threshold ``mu`` derived from the *training*
(normal-only) errors:

    unusual IQR:  mu = Q3 + 1.5 * IQR
    extreme IQR:  mu = Q3 + 3.0 * IQR

or a plain quantile (e.g. Q90).  Quantiles are NaN-aware and interpolate
linearly (:func:`nanquantile`), as ``jnp.nanquantile`` does, for any number
of errors.

Every function takes ``device=``: ``None`` means the card (see
:mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import as_tensor, resolve_device


def parse_quantile_rule(rule: str) -> float | None:
    """Parse a ``"q<percent>"`` rule into its percent, or None if ``rule``
    is not quantile-shaped (fractional and zero-padded percents included:
    "q90", "q97.5", "q05").

    Raises:
        ValueError: quantile-shaped but with a percent outside (0, 100).
    """
    if not rule.startswith("q"):
        return None
    try:
        pct = float(rule[1:])
    except ValueError:
        return None
    if not 0.0 < pct < 100.0:
        raise ValueError(
            f"threshold rule {rule!r}: quantile percent must be in "
            f"(0, 100), got {pct:g}"
        )
    return pct


def nanquantile(x: torch.Tensor, *qs: float) -> tuple[torch.Tensor, ...]:
    """The ``q`` quantile of each row of ``x`` (of ``x`` itself when 1-D) for
    each ``q`` of ``qs``, NaNs ignored, interpolated linearly:
    ``np.nanquantile(x, q, axis=-1)`` with numpy's arithmetic, on ``x``'s
    device and in its dtype, for any row length (``torch.nanquantile``
    refuses more than 2^24 elements).  One sort serves every ``q``.  A row
    with no value that is not NaN gives NaN.
    """
    if x.shape[-1] == 0:
        nan = torch.full(x.shape[:-1], torch.nan, dtype=x.dtype, device=x.device)
        return tuple(nan for _ in qs)
    s = torch.sort(x, dim=-1).values                           # NaNs sort last
    count = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    last = (count - 1).clamp(min=0)
    out = []
    for q in qs:
        # numpy: q in the data's dtype, virtual index (n - 1) * q, its floor
        # and the next index, both the last value where it reaches n - 1.
        virtual = (count - 1).to(x.dtype) * torch.tensor(q, dtype=x.dtype, device=x.device)
        above = virtual >= (count - 1).to(x.dtype)
        below = torch.floor(virtual)
        gamma = virtual - torch.where(above, -1.0, below)
        lo = torch.where(above, last, below.long())
        hi = torch.where(above, last, (below.long() + 1).clamp(max=last))
        a, b = torch.gather(s, -1, lo), torch.gather(s, -1, hi)
        diff = b - a                                           # numpy's _lerp
        lerp = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
        out.append(torch.where(count == 0, torch.nan, lerp).squeeze(-1))
    return tuple(out)


def threshold(train_errors, rule: str = "extreme_iqr", *, device=None) -> torch.Tensor:
    """mu (a 0-d tensor) from training reconstruction errors [n]; or one mu
    per row, [K], from a fleet's errors [K, n] (one quantile call for every
    tenant, as the reference's ``vmap`` of this function gives).

    rule: "unusual_iqr" | "extreme_iqr" | "q<percent>".
    """
    errs = as_tensor(train_errors, resolve_device(device))
    pct = parse_quantile_rule(rule)
    if pct is not None:
        return nanquantile(errs, pct / 100.0)[0]
    q1, q3 = nanquantile(errs, 0.25, 0.75)
    iqr = q3 - q1
    if rule == "unusual_iqr":
        return q3 + 1.5 * iqr
    if rule == "extreme_iqr":
        return q3 + 3.0 * iqr
    raise ValueError(f"unknown threshold rule {rule!r}")


def classify(errors, mu, *, device=None) -> torch.Tensor:
    """1 = anomaly, 0 = normal (int32)."""
    dev = resolve_device(device)
    errs = as_tensor(errors, dev)
    return (errs > as_tensor(mu, dev, errs.dtype)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BinaryMetrics:
    f1: float
    precision: float
    recall: float
    accuracy: float
    tp: int
    fp: int
    fn: int
    tn: int


def binary_metrics(pred, truth, *, device=None) -> BinaryMetrics:
    """F1 & friends with anomaly (1) as the positive class."""
    dev = resolve_device(device)
    pred = torch.as_tensor(pred, device=dev).to(torch.bool)
    truth = torch.as_tensor(truth, device=dev).to(torch.bool)
    tp = int(torch.sum(pred & truth))
    fp = int(torch.sum(pred & ~truth))
    fn = int(torch.sum(~pred & truth))
    tn = int(torch.sum(~pred & ~truth))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    accuracy = (tp + tn) / max(1, tp + fp + fn + tn)
    return BinaryMetrics(
        f1=f1, precision=precision, recall=recall, accuracy=accuracy,
        tp=tp, fp=fp, fn=fn, tn=tn,
    )


def evaluate(
    train_errors, test_errors, truth, rule: str = "extreme_iqr", *, device=None
) -> BinaryMetrics:
    dev = resolve_device(device)
    mu = threshold(train_errors, rule, device=dev)
    return binary_metrics(classify(test_errors, mu, device=dev), truth, device=dev)
