"""Anomaly detection on top of reconstruction errors (paper §6).

Counterpart of ``repro/core/anomaly.py``.  A sample is anomalous iff its
reconstruction MSE exceeds a threshold ``mu`` derived from the *training*
(normal-only) errors:

    unusual IQR:  mu = Q3 + 1.5 * IQR
    extreme IQR:  mu = Q3 + 3.0 * IQR

or a plain quantile (e.g. Q90).  Quantiles are NaN-aware and interpolate
linearly (``torch.nanquantile``), as ``jnp.nanquantile`` does.

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


def threshold(train_errors, rule: str = "extreme_iqr", *, device=None) -> torch.Tensor:
    """mu (a 0-d tensor) from training reconstruction errors [n]; or one mu
    per row, [K], from a fleet's errors [K, n] (one quantile call for every
    tenant, as the reference's ``vmap`` of this function gives).

    rule: "unusual_iqr" | "extreme_iqr" | "q<percent>".
    """
    errs = as_tensor(train_errors, resolve_device(device))
    dim = -1 if errs.ndim > 1 else None
    pct = parse_quantile_rule(rule)
    if pct is not None:
        return torch.nanquantile(errs, pct / 100.0, dim=dim, interpolation="linear")
    q1 = torch.nanquantile(errs, 0.25, dim=dim, interpolation="linear")
    q3 = torch.nanquantile(errs, 0.75, dim=dim, interpolation="linear")
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
